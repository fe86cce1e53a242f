"""Control plane of the port's training and serving fleets (from
``repro.training``).  Ported so far: ``elastic.py``; the optimizer, train
loop and checkpoints come with the training slice."""
from .elastic import BackupPolicy, ElasticPlan, HealthTracker, choose_mesh_shape, plan_rescale  # noqa: F401
