"""Near-duplicate groups on which a plain dot and the cosine order rows
differently.

G groups of ``group`` unit rows at ``dim``, each row perturbed by ``eps``
around its group's base, and one query per group perturbed the same way, all
drawn from a numpy seed.  Inside a group the dots differ below float32's
resolution, so a dot (the gather kernel's score) and the cosine, which
divides by the norms, often pick different rows: about 2 % of groups at the
defaults.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.lsh import normalize
from ..core.similarity import cosine


def near_tie_trace(n_groups: int, seed: int, group: int = 8, dim: int = 64,
                   eps: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """(rows (G, group, dim), queries (G, dim)), unit float32, from ``seed``."""
    rng = np.random.default_rng(seed)
    base = normalize(rng.standard_normal((n_groups, dim)).astype(np.float32))
    rows = normalize((base[:, None] + eps * rng.standard_normal(
        (n_groups, group, dim))).astype(np.float32))
    q = normalize((base + eps * rng.standard_normal((n_groups, dim))).astype(np.float32))
    return rows, q


def dot_cosine_disagree(rows: np.ndarray, q: np.ndarray) -> int:
    """Groups whose best row by a plain dot is not their best by cosine."""
    return sum(int(np.argmax(r @ x) != np.argmax(cosine(x, r))) for r, x in zip(rows, q))
