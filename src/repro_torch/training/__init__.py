"""Training of the port (``repro.training``): AdamW with quantised moments,
the microbatched train step, fault-tolerant checkpoints, and the control
plane of the training and serving fleets (``elastic.py``)."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, resume_or_init, save  # noqa: F401
from .elastic import BackupPolicy, ElasticPlan, HealthTracker, choose_mesh_shape, plan_rescale  # noqa: F401
from .optimizer import OptimizerConfig, adamw_init, adamw_update, lr_at  # noqa: F401
from .train_loop import init_state, make_eval_step, make_train_step  # noqa: F401
