"""Expert parallelism of the port's MoE under a mesh, on 4 CPU ranks.

With ``moe_dispatch_groups = G`` > 1 and each group whole inside one rank's
batch shard, each data rank routes only its own groups and the tokens
reach their experts by all-to-all (``models/moe.py::_expert_parallel``).
Each case starts 4 gloo ranks (``tests/torch_layout_worker.py``, a (2, 2)
("data", "model") mesh, through a ``FileStore`` under ``tmp_path``):

* (a) reduced qwen2-moe in ``ep`` (experts over "data") with G = 2, 8
  experts: two train steps on DTensors placed by ``state_shardings`` within
  1e-5 of one device (losses, parameters, every gradient), every gradient
  reaching the optimizer with its ``grad_shardings`` placements; the same
  in ``fsdp`` (experts over "model": a rank's own groups stay on it and
  only its experts' slice is taken);
* (b) the same with 5 experts, 3 and 2 a data rank (uneven);
* (c) reduced llama4 (top-1 and a shared expert) with G = 2: a prefill and
  one decode step within 1e-5 of one device;
* (d) a hook on ``moe.route``: each rank routes N / G tokens a call and
  G / n_data calls where one device makes G; a group that straddles two
  ranks' shards (G = 3 over 2 data ranks) is routed whole on every rank,
  as one device routes it;
* (e) without groups in ``fsdp`` (``moe._split_hidden``: each rank's
  experts over its chunk of their hidden; the shared MLP's contraction
  split over "model" for a rank with fewer tokens than d_model): reduced
  qwen2-moe and llama4, two train steps and a prefill with a decode step
  within 1e-5 of one device, with the same dropped pairs in every
  dispatch (capacity_factor 1 drops some).

Then the accounting of a fake world of 16 ranks as a (4, 4) mesh (one
process, ``mesh.start_fake_world``): a reduced MoE block in ``ep`` under
``hlo_analysis``, whose expert products on rank 0 take
``2 G ceil(E / n_data) C d 3f / n_model`` FLOPs a forward, with an
all-to-all among the collectives and no all-gather of the whole tokens;
and the block in ``fsdp`` without groups, whose products on rank 0 have
the split shapes of the reference's compiled dry run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_layout_dist import ROOT, TOL, _run

from repro_torch.configs import get_arch
from repro_torch.models import build_model, moe

SHAPE_TOKENS = 4 * 32      # the worker's train batch (B, S) = (4, 32)
N_DATA = 2


def _check_steps(results):
    for r, res in enumerate(results):
        assert res["bad"] == [], res["bad"][:5]
        assert res["n_grads"] > 0 and res["n_sharded"] > 0
        for got, want in zip(res["got"], res["want"]):
            assert abs(got - want) <= TOL, (r, res["got"], res["want"])
        assert res["param_gap"] <= TOL, (r, res["param_gap"])
        assert res["grad_gap"] <= TOL, (r, res["grad_gap"])


@pytest.fixture(scope="module")
def ep_g2(tmp_path_factory):
    """Case (a)'s ranks' results (shared with (d))."""
    return _run("qwen2-moe-a2.7b:ep:moe_dispatch_groups=2", tmp_path_factory.mktemp("ep"))


def test_ep_steps_match_one_device(ep_g2):
    _check_steps(ep_g2)


@pytest.mark.parametrize("case", ["qwen2-moe-a2.7b:fsdp:moe_dispatch_groups=2",
                                  "qwen2-moe-a2.7b:ep:moe_dispatch_groups=2:n_experts=5"])
def test_grouped_steps_match_one_device(case, tmp_path):
    _check_steps(_run(case, tmp_path))


def test_each_rank_routes_its_own_groups(ep_g2):
    G = 2
    for res in ep_g2:
        assert res["routes_plain"] and set(res["routes_plain"]) == {SHAPE_TOKENS // G}
        assert set(res["routes_mesh"]) == {SHAPE_TOKENS // G}
        assert len(res["routes_mesh"]) * N_DATA == len(res["routes_plain"])


def test_straddling_groups_route_whole(tmp_path):
    """G = 3 groups of a (4, 24) batch over 2 data ranks: the middle group
    straddles both shards, and every rank routes every group."""
    results = _run("qwen2-moe-a2.7b:ep:moe_dispatch_groups=3:seq=24", tmp_path)
    _check_steps(results)
    for res in results:
        assert set(res["routes_mesh"]) == {4 * 24 // 3}
        assert res["routes_mesh"] == res["routes_plain"]


def _decode_matches_one_device(arch: str, over: dict, tmp_path) -> None:
    """A prefill of 2 x 12 tokens (and llama4's 8 patch tokens) and a decode
    step of reduced ``arch`` with the config fields ``over``, parameters as
    "fsdp" places them on the 4 ranks, against the same model on one
    device: each step's logits within 1e-5 and, without dispatch groups,
    the same dropped pairs in each dispatch."""
    S, steps, max_len = 12, 1, 32
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    model = build_model(cfg, "cpu", seed=0)
    rng = np.random.default_rng(25)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S + steps)).astype(np.int32))
    nf = cfg.n_frontend_tokens
    extra = {"patch_embeds": torch.from_numpy(
        (rng.standard_normal((2, nf, cfg.d_model)) * 0.02).astype(np.float32))} if nf else {}
    drops, dispatch = [], moe.dispatch

    def recording(expert_ids, n_experts, cap):
        out = dispatch(expert_ids, n_experts, cap)
        drops.append(int((~out[2]).sum()))
        return out

    moe.dispatch = recording
    try:
        with torch.no_grad():
            logits, cache = model.prefill({"tokens": tokens[:, :S], **extra}, max_len,
                                          cache_dtype=torch.float32)
            one = [logits.numpy()]
            for step in range(steps):
                logits, cache = model.decode_step(tokens[:, S + step:S + step + 1], cache,
                                                  S + nf + step)
                one.append(logits.numpy())
    finally:
        moe.dispatch = dispatch
    data = {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "tokens": tokens, "S": S, "steps": steps, "max_len": max_len, "extra": extra,
            "pos0": S + nf}
    torch.save(data, tmp_path / "decode_in.pt")
    parts = "".join(f":{k}={v}" for k, v in over.items())
    for r, res in enumerate(_run(f"decode:{arch}{parts}", tmp_path)):
        assert res["bad"] == [], (r, res["bad"][:5])
        if not over.get("moe_dispatch_groups"):   # grouped: each rank its own groups
            assert res["drops"] == drops, (r, res["drops"], drops)
        for step, (got, o) in enumerate(zip(res["logits"], one)):
            np.testing.assert_allclose(np.asarray(got, np.float32), o, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r} {step}")


def test_llama4_grouped_decode_matches_one_device(tmp_path):
    """Reduced llama4 with G = 2: a prefill of 2 x (12 + 8 patch) tokens, a
    group a data rank, and a decode step (a token a group), parameters as
    "fsdp" places them, against the same model on one device."""
    _decode_matches_one_device("llama4-maverick-400b-a17b", {"moe_dispatch_groups": 2},
                               tmp_path)


# "fsdp" without dispatch groups: reduced qwen2-moe (top-4, a shared MLP of
# 4 experts' width) and llama4 (top-1 and a shared expert), 8 experts over
# the 2 model ranks; 5 (3 and 2, stored whole over "model"); a capacity of
# k N / E (capacity_factor 1), which drops pairs
NO_GROUPS = ["qwen2-moe-a2.7b:fsdp", "qwen2-moe-a2.7b:fsdp:capacity_factor=1",
             "llama4-maverick-400b-a17b:fsdp", "llama4-maverick-400b-a17b:fsdp:n_experts=5"]


@pytest.mark.parametrize("case", NO_GROUPS)
def test_no_group_steps_match_one_device(case, tmp_path):
    """Two train steps without dispatch groups: each rank routes every token
    (as one device does), computes its experts over its chunk of their
    hidden (``moe._split_hidden``) and the shared MLP on its tokens;
    losses, parameters and every gradient within 1e-5 of one device, the
    same dropped pairs in every dispatch."""
    results = _run(case, tmp_path)
    _check_steps(results)
    for res in results:
        assert res["routes_mesh"] == res["routes_plain"]
        assert res["drops_mesh"] == res["drops_plain"]
    if "capacity_factor=1" in case:
        assert sum(res["drops_plain"]) > 0


@pytest.mark.parametrize("arch,over", [("qwen2-moe-a2.7b", {}),
                                       ("llama4-maverick-400b-a17b", {}),
                                       ("qwen2-moe-a2.7b", {"capacity_factor": 1})])
def test_no_group_decode_matches_one_device(arch, over, tmp_path):
    """A prefill and a decode step without dispatch groups (a rank's 1 to 20
    tokens, fewer than d_model: the shared MLP's contraction split over
    "model") within 1e-5 of one device, with the same drops."""
    _decode_matches_one_device(arch, over, tmp_path)


def _fake_world(mode: str) -> list:
    """``tests/torch_moe_fake_world.py MODE``'s runs."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(Path(__file__).with_name(
        "torch_moe_fake_world.py")), mode], env=env, capture_output=True, text=True,
        timeout=180)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_fake_world_accounting():
    """A reduced block (d = 64, E = 6 over 4 data ranks: 2, 2, 2, 0; f = 32
    over 4 model ranks; G = 8 groups of 32 tokens, C = 10) on rank 0 of a
    fake world of 16: the expert products' FLOPs by the formula, an
    all-to-all, and no all-gather holding the whole (B S, d) tokens."""
    got, = _fake_world("ep")
    G, E, n_data, n_model, d, f = 8, 6, 4, 4, 64, 32
    C = max(8, int(2 * (8 * 32 // G) * 1.0 / E))
    assert got["expert_flops"] == 2 * G * -(-E // n_data) * C * d * 3 * f / n_model, got
    assert got["collectives"].get("all-to-all", 0) > 0, got
    whole = 8 * 32 * d * 2          # the (B S, d) tokens in bf16
    assert all(b < whole for b in got["all_gather_sizes"]), got


def test_fake_world_no_group_accounting():
    """The same block in "fsdp" without groups on rank 0 of the fake world
    of 16 (E = 6 over 4 model ranks: 2, 2, 2, 0, stored whole; d_in and the
    hidden f = 32 over 4 data ranks), as the reference's compiled products
    are split (the by-op comparison of its dry run): each rank's experts
    over the whole capacity (C = 85 of 256 tokens, 8 of 8) but only its
    chunk of the hidden, wi's 2 x 8 gate and up columns and wo's 8 rows.
    The shared MLP: a rank's 64 tokens (as many as d_model) over the whole
    hidden (64 columns); a decode step's 2 tokens contract over d / 4 =
    16 (d over "model") before the sum."""
    train, step = _fake_world("fsdp")
    d, f = 64, 32
    for res, C in ((train, max(8, int(2 * 8 * 32 * 1.0 / 6))), (step, 8)):
        assert res["bmm"] == [[[2, C, d], [2, d, 2 * f // 4]], [[2, C, f // 4], [2, f // 4, d]]]
        assert res["expert_flops"] == 2 * 2 * C * d * 3 * f / 4, res
    assert [[64, d], [d, 2 * f]] in train["mm"], train["mm"]
    assert [[2, d // 4], [d // 4, 2 * f]] in step["mm"], step["mm"]
    assert [[2, d], [d, 2 * f]] not in step["mm"], step["mm"]
