"""Synthetic task-input streams mirroring the paper's five datasets (Table II).

Port of ``repro/data/synthetic.py``: numpy only, so every stream is
bit-equal to the reference's.

We cannot ship MNIST/Pandaset/CCTV footage, so we generate embedding streams
with the *statistical structure that matters to Reservoir*: the degree of
correlation between consecutive task inputs (low / moderate / high) and the
granularity of the service's processing (coarse / medium / fine).  Each
dataset is a cloud of sub-clusters on the unit sphere:

* class centres  ~ service-level semantic classes (digits, objects, traffic)
* sub-centres    ~ distinct instances (a specific sight, a specific scene)
* items          ~ captures of an instance (angles, consecutive frames)

The *stream ordering* encodes correlation: ``high`` emits long runs of tiny-
perturbation frames (CCTV video), ``moderate`` emits bursts of views of one
object (Stanford AR), ``low`` draws i.i.d. (MNIST/Pandaset).

The *service* executed on an input is a deterministic labelling function
(nearest sub-centre mapped through the granularity), so "reuse accuracy" is
well-defined exactly as the paper defines it: would the reused result equal
the result of executing the incoming task from scratch?
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from ..core.edge_node import Service
from ..core.lsh import normalize


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    dim: int = 64
    n_classes: int = 10
    subs_per_class: int = 8
    correlation: str = "low"      # 'low' | 'moderate' | 'high'
    granularity: str = "medium"   # 'coarse' | 'medium' | 'fine'
    sub_spread: float = 0.55      # L2 distance of a sub-centre from its class centre
    item_noise: float = 0.30      # L2 norm of capture noise around a sub-centre
    walk_noise: float = 0.06      # L2 frame-to-frame drift for 'high' streams
    run_length: int = 30          # mean frames per run ('high'/'moderate')
    seed: int = 1234

    def centers(self) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        cls = normalize(rng.standard_normal((self.n_classes, self.dim)))
        subs = cls[:, None, :] + self.sub_spread * _unit_noise(
            rng, (self.n_classes, self.subs_per_class, self.dim)
        )
        return cls, normalize(subs.reshape(-1, self.dim))


def _unit_noise(rng: np.random.Generator, shape) -> np.ndarray:
    """Gaussian noise scaled so each vector has unit expected L2 norm.

    All noise knobs in ``DatasetSpec`` are therefore L2 distances on the unit
    sphere (cosine similarity of a perturbed item ~= 1/sqrt(1+scale^2)).
    """
    n = rng.standard_normal(shape)
    return n / np.sqrt(shape[-1])


# Calibrated to Table II's correlation / granularity columns.
DATASETS: Dict[str, DatasetSpec] = {
    "mnist": DatasetSpec("mnist", correlation="low", granularity="medium",
                         n_classes=10, subs_per_class=12, item_noise=0.42),
    "pandaset": DatasetSpec("pandaset", correlation="low", granularity="fine",
                            n_classes=12, subs_per_class=10,
                            sub_spread=0.45, item_noise=0.40),
    "stanford_ar": DatasetSpec("stanford_ar", correlation="moderate",
                               granularity="medium", n_classes=8,
                               subs_per_class=6, item_noise=0.22),
    "cctv1": DatasetSpec("cctv1", correlation="high", granularity="coarse",
                         n_classes=6, subs_per_class=6, item_noise=0.30),
    "cctv2": DatasetSpec("cctv2", correlation="high", granularity="fine",
                         n_classes=6, subs_per_class=6,
                         sub_spread=0.45, item_noise=0.30),
}


def _labeler(spec: DatasetSpec) -> Callable[[np.ndarray], int]:
    _, subs = spec.centers()
    n_sub = spec.subs_per_class

    def label(x: np.ndarray) -> int:
        x = normalize(np.asarray(x, np.float32).reshape(-1))
        sub_id = int(np.argmax(subs @ x))
        cls_id = sub_id // n_sub
        if spec.granularity == "coarse":
            return cls_id % 2          # e.g. "is there traffic?"
        if spec.granularity == "medium":
            return cls_id              # e.g. digit / object identity
        return sub_id                  # fine: exact instance / count

    return label


def make_stream(spec: DatasetSpec, n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Generate (X, labels): n task inputs in stream order + ground truth."""
    rng = np.random.default_rng(seed ^ spec.seed)
    _, subs = spec.centers()
    label = _labeler(spec)
    xs = np.empty((n, spec.dim), np.float32)
    i = 0
    while i < n:
        sub = subs[rng.integers(len(subs))]
        if spec.correlation == "low":
            xs[i] = sub + spec.item_noise * _unit_noise(rng, (spec.dim,))
            i += 1
        elif spec.correlation == "moderate":
            burst = int(rng.geometric(1.0 / max(2, spec.run_length // 5)))
            for _ in range(min(burst, n - i)):
                xs[i] = sub + spec.item_noise * _unit_noise(rng, (spec.dim,))
                i += 1
        else:  # high: video-like random walk inside a sub-cluster
            run = int(rng.geometric(1.0 / spec.run_length))
            cur = sub + spec.item_noise * _unit_noise(rng, (spec.dim,))
            for _ in range(min(run, n - i)):
                xs[i] = cur
                cur = cur + spec.walk_noise * _unit_noise(rng, (spec.dim,))
                i += 1
    xs = normalize(xs)
    labels = np.asarray([label(x) for x in xs], np.int64)
    return xs, labels


def dataset_service(spec: DatasetSpec, exec_time_s=(0.070, 0.100)) -> Service:
    """The edge service for a dataset: deterministic labelling function.

    ``execute`` is a pure function of the input, standing in for the paper's
    tensorflow models (70-100 ms per image, §V-C) — the semantics that matter
    for reuse-accuracy measurements are 'what result would from-scratch
    execution produce', which this provides exactly.
    """
    label = _labeler(spec)
    return Service(
        name=f"/{spec.name}",
        execute=lambda x: label(x),
        exec_time_s=exec_time_s,
        input_dim=spec.dim,
        kind="classification",
    )
