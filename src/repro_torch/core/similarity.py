"""Similarity measures supported by Reservoir (paper §IV-E).

The paper notes Reservoir "can support the use of various similarity forms and
algorithms (e.g., structural similarity, cosine similarity) [25], [26]".  ENs
compare an incoming task's input embedding against stored inputs and reuse the
nearest neighbour iff similarity exceeds the task-carried threshold.
"""
from __future__ import annotations

import numpy as np


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cosine similarity between a (D,) query and a (N, D) store -> (N,)."""
    a = np.asarray(a, np.float32)
    b = np.atleast_2d(np.asarray(b, np.float32))
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b, axis=-1)
    return (b @ a) / np.maximum(na * nb, 1e-12)


def structural(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SSIM-style similarity (global statistics form, [25]) for flat vectors.

    ssim = ((2 mu_a mu_b + c1)(2 cov + c2)) / ((mu_a^2 + mu_b^2 + c1)(var_a + var_b + c2))
    """
    a = np.asarray(a, np.float64)
    b = np.atleast_2d(np.asarray(b, np.float64))
    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = a.mean(), b.mean(axis=-1)
    var_a, var_b = a.var(), b.var(axis=-1)
    cov = ((b - mu_b[:, None]) * (a - mu_a)).mean(axis=-1)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return (num / np.maximum(den, 1e-12)).astype(np.float32)


SIMILARITY_FNS = {"cosine": cosine, "structural": structural}


def get_similarity(name: str):
    try:
        return SIMILARITY_FNS[name]
    except KeyError:
        raise ValueError(f"unknown similarity {name!r}; have {sorted(SIMILARITY_FNS)}")
