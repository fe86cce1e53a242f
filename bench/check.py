"""How ``correct`` is decided: the timed window's own outputs against the
plain references, once the window has closed and the program's state is
freed.

Numbers compared (each with its limit in the configuration's ``check``):

- ``reuse_wrong``: answers of the fill's routing and of every round (warm
  and timed) that the reuse reference (``reference/reuse.py``) cannot
  reconcile with its rules: the replica, the kind (Content Store, store
  hit, execution), the entry reused and the result returned.  Every answer
  is held to what the state alone decides; a seeded share of the rounds,
  about ``judge_queries`` store answers, is also checked against the
  probed candidates.
- ``token_gap``: over a seeded sample of executed tasks (``check_tasks``),
  the widest gap by which the served token's logit lies below the
  reference's best, in units of the reference row's standard deviation.
- ``logit_err``: over the same tasks, the widest gap between the
  last-position logits the timed path made and the reference's, in the
  same units.

The controls put the reference in the program's place one precision down:
the reuse layer's products from TF32-rounded inputs (the configuration
states float32), the model's matrix products in float8 e4m3 (it serves in
bfloat16).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from bench.reference import dense_lm
from bench.reference.reuse import Answer, Fleet, unit
from bench.weights import Weights, sub_seed

NUMBERS = ("reuse_wrong", "token_gap", "logit_err")


def answers_of(results: Sequence[Optional[tuple]]) -> List[Optional[Answer]]:
    """(replica, reuse, result, similarity) of each task as an Answer."""
    return [None if r is None else Answer(*r) for r in results]


def full_rounds(rounds: Sequence[Sequence[Optional[Answer]]], seed: int, budget: int
                ) -> np.ndarray:
    """Which rounds get the full check: a seeded share of them, about
    ``budget`` store answers."""
    store = np.asarray([sum(1 for a in r if a is not None and a.kind != "cs") for r in rounds])
    share = min(1.0, budget / max(int(store.sum()), 1))
    return np.random.default_rng(sub_seed(seed, "sample", 1)).random(len(rounds)) < share


def n_max(dep: Mapping, rounds: Sequence[Sequence[Optional[Answer]]]) -> int:
    return int(dep["store_capacity"]) + sum(len(r) for r in rounds) + 8


def judge_reuse(dep: Mapping, fill: Sequence[np.ndarray], xs: Sequence[np.ndarray],
                task_ids: Sequence[Sequence[int]],
                answers: Sequence[Sequence[Optional[Answer]]], routes: Sequence[np.ndarray],
                names: Sequence[np.ndarray], full: np.ndarray, device: torch.device) -> Fleet:
    """The reference fleet after holding every answer to its rules (its
    hash's products on ``device``).  ``fill``: the fill's rows, replicas and
    router buckets."""
    ref = Fleet(dep, n_max(dep, answers), device=device)
    rows, owners, buckets = fill
    ref.fill(rows, owners, buckets, list(range(len(rows))))
    for args in zip(xs, task_ids, answers, routes, names, full):
        ref.judge_round(*args[:5], bool(args[5]))
    return ref


def control_reuse(dep: Mapping, fill_rows: np.ndarray, xs, task_ids, full: np.ndarray,
                  device: torch.device) -> Fleet:
    """The control: a TF32 fleet answers the same fill and rounds, and the
    reference judges its answers."""
    rounds = [[None] * len(ids) for ids in task_ids]
    ctrl = Fleet(dep, n_max(dep, rounds), "tf32", device)
    buckets = ctrl.lsh.hash(unit(fill_rows)).buckets
    owners = ctrl.lsh.owners(buckets, ctrl.r)
    keys = list(range(len(fill_rows)))
    ctrl.fill(fill_rows, owners, buckets, keys)
    ref = Fleet(dep, n_max(dep, rounds), device=device)
    ref.fill(fill_rows, owners, buckets, keys)
    for x, ids, f in zip(xs, task_ids, full):
        ans, names = ctrl.decide_round(x, ids, lambda t: [(i, 0) for i in t])
        ref.judge_round(x, ids, ans, names, names, bool(f))
    return ref


def model_numbers(m: Mapping, seed: int, device: torch.device, tokens: torch.Tensor,
                  served: torch.Tensor, program: torch.Tensor, control: bool = False
                  ) -> Dict[str, float]:
    """token_gap and logit_err of the program's served tokens and logits
    against the float32 reference on the same prompts; with ``control``
    the float8 control's too."""
    w = Weights(m, seed, device)
    ref = dense_lm.last_logits(w, m, tokens.to(device))
    std = ref.std(dim=-1)
    best = ref.max(dim=-1).values

    def gap(tok: torch.Tensor) -> float:
        return float(((best - ref.gather(1, tok[:, None].to(device).long())[:, 0]) / std).max())

    def err(lg: torch.Tensor) -> float:
        return float(((lg.to(device) - ref).abs().max(dim=-1).values / std).max())

    out = {"token_gap": gap(served), "logit_err": err(program)}
    if control:
        c = dense_lm.last_logits(w, m, tokens.to(device), matmul=dense_lm.fp8_matmul)
        out.update(control_token_gap=gap(c.argmax(dim=-1)), control_logit_err=err(c))
    return out


def verdict(values: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    return all(values[k] <= limits[k] for k in NUMBERS)


def lines(values: Mapping[str, float], limits: Mapping[str, float]) -> List[str]:
    return [f"check {k} {values[k]!r} limit {limits[k]!r}" for k in NUMBERS]
