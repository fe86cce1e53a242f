"""Sharded train steps of the port on 4 CPU ranks against one device.

Each case starts 4 processes (``tests/torch_layout_worker.py``) that join
a gloo group through a ``FileStore`` under ``tmp_path`` (no network) and
build a (2, 2) ("data", "model") mesh.  Two train steps of a reduced config
run with the state as DTensors placed by ``state_shardings`` (reduced
qwen3 in "tp" and in "fsdp", the latter also with int8 moments and int8
gradient compression, reduced qwen2-moe in "ep" with experts over "data",
reduced xLSTM, whose layout is pure data parallelism, reduced zamba2 in
"tp" and "fsdp", whose Mamba2 layers split their heads over "model"), and the
same two steps run on one device with plain tensors from the same state.
The losses and the updated parameters agree within 1e-5, and so does each
gradient the optimizer receives (relative to its largest value); every
leaf of the state (parameters, moments, residuals, the step) keeps its
``state_shardings`` placements, and every gradient
reaches the optimizer with its ``grad_shardings`` placements.  A rank that
hangs fails its case at the time limit; the case's processes are then
killed.  One more case holds K6 on DTensors (the GQA head split) and its
gradients against plain tensors.  Three cases split unevenly over "model",
as the reference's constraints do: q heads that 2 ranks do not divide (3
heads over 1 kv head in "tp", 9 over 3 in "fsdp", whose rank 0 straddles
kv groups) and seamless's vocabulary at 257 rows; each rank's K6 calls and
logits hold only its own share; so do two zamba2 cases, each rank's
Mamba2 scans holding its 4 of 8 heads, and 2 and 1 of 3 (``d_model=48``,
``ssm_head_dim=32``: in_proj's 227 columns stay whole over "model", out_proj's
rows and the conv channels move to the heads).

One gradient is held to a limit of its own, ``LEAF_TOL``: a Mamba2 layer's
``A_log`` gradient sums cancelling terms over every position, so that a
relative perturbation of 1e-7 in the hidden states' gradient moves it by
more than 1e-5 of its largest value on one device (reduced zamba2,
``test_torch_mamba_split.py::test_alog_gradient_amplifies_a_tiny_perturbation``),
and the mesh's partial sums (attention's and the logits') perturb it so:
1.7e-5 to 2.6e-5 in the zamba2 cases here (the worker's ``grad_gaps``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_layout_worker.py")
WORLD = 4
TIME_LIMIT = 180   # seconds a case may take, all ranks together
TOL = 1e-5
LEAF_TOL = {"A_log": 1e-4}   # see the module docstring


def _run(case, tmp_path):
    """Start the case's ranks, wait for them within TIME_LIMIT, and return
    each rank's JSON result."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.json" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(r), str(WORLD),
                               str(store), str(outs[r])], env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIME_LIMIT)[0].decode(errors="replace") for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: a rank did not finish within {TIME_LIMIT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [json.loads(out.read_text()) for out in outs]


def _grads_close(res) -> bool:
    """Every gradient within TOL of one device's (relative to its largest
    value), a leaf named in LEAF_TOL within its own limit."""
    return all(gap <= LEAF_TOL.get(name.rsplit(".", 1)[-1], TOL)
               for name, gap in res["grad_gaps"].items())


@pytest.mark.parametrize("case", ["qwen3-1.7b:tp", "qwen3-1.7b:fsdp", "qwen3-1.7b:fsdp:int8",
                                  "qwen2-moe-a2.7b:ep", "xlstm-125m:tp", "zamba2-7b:tp",
                                  "zamba2-7b:fsdp"])
def test_sharded_steps_match_one_device(case, tmp_path):
    for r, res in enumerate(_run(case, tmp_path)):
        assert res["bad"] == [], res["bad"][:5]
        assert res["n_grads"] > 0
        for got, want in zip(res["got"], res["want"]):
            assert abs(got - want) <= TOL, (r, res["got"], res["want"])
        assert res["param_gap"] <= TOL, (r, res["param_gap"])
        assert _grads_close(res), (r, res["grad_gaps"])
    if not case.startswith("xlstm"):   # pure DP replicates every xLSTM block
        assert res["n_sharded"] > 0


# each rank's share of the work where "model" (2 ranks) does not divide it,
# by model rank: q heads of its K6 calls (3 heads over 1 kv head: 2 and 1; 9
# over 3: heads 0-4, runs of 3 and 2 in kv heads 0 and 1, and heads 5-8, of
# 1 and 3 in kv heads 1 and 2), vocabulary columns a logits shard (257: 129
# and 128)
LOCAL_WORK = {"qwen3-1.7b:tp:n_heads=3:n_kv_heads=1": ("k6_heads", [[2], [1]]),
              "qwen3-1.7b:fsdp:n_heads=9:n_kv_heads=3": ("k6_heads", [[2, 3], [1, 3]]),
              "seamless-m4t-large-v2:fsdp:vocab_size=257": ("logit_cols", [[129], [128]])}


@pytest.mark.parametrize("case", sorted(LOCAL_WORK))
def test_uneven_split_is_rank_local(case, tmp_path):
    """The uneven cases above: each rank's K6 calls take only its own q heads
    (ceil(H / 2) on model rank 0, the rest on rank 1), and each rank's
    logits only its own chunk of the vocabulary, and each rank's Mamba2
    scans only its own heads; losses, parameters and gradients within 1e-5
    of one device (``LEAF_TOL`` aside)."""
    key, want = LOCAL_WORK[case]
    for r, res in enumerate(_run(case, tmp_path)):
        assert res["bad"] == [], res["bad"][:5]
        for got, one in zip(res["got"], res["want"]):
            assert abs(got - one) <= TOL, (r, res["got"], res["want"])
        assert res["param_gap"] <= TOL and _grads_close(res), res
        assert res[key] == want[r % 2], (r, key, res[key])   # rank r: model rank r % 2


def test_sharded_attention_matches_one_device(tmp_path):
    """K6 on DTensors over the (2, 2) mesh, forward and gradients, within 1e-5
    (relative to the largest value) of plain tensors; heads split over
    "model" in every case: heads that cover whole kv heads, lie within one,
    straddle two (6 heads over 3 kv heads), split unevenly (9 over 3: 5
    and 4) or leave a rank without heads (1 over 1: 1 and 0)."""
    for res in _run("attention:gqa", tmp_path):
        assert res["gap"] <= TOL, res["gap"]
        assert res["placements"] == [[0, 2]] * 6   # Shard(d) as d
