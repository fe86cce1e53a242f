"""A decode step at batch 1 on a mesh: the reference's compiled layout.

Where the batch axes do not divide the batch (B = 1 on 16 data ranks), the
port decodes under ``partitioning.embed_split``: weights stay where FSDP
stores them, the residual stream's d is split over "data", products that
contract d reduce their partial sums over "data", and K7 splits its heads
over "data" (``ops.sharded_decode_attention``).

* On 4 gloo ranks (``tests/torch_layout_worker.py``, a (2, 2) ("data",
  "model") mesh): reduced qwen3, zamba2, seamless and xLSTM at B = 1 take a
  prefill and 3 decode steps on DTensors, parameters placed by
  ``state_shardings`` ("fsdp"); every rank's logits within 1e-5 of one
  device's and of the reference's ``decode_step``.  In the decode steps no
  parameter is all-gathered over "data": every all-gather over "data" is
  smaller than the smallest shard of a parameter that "data" splits, and
  none has such a shard's shape; each K7 call takes the rank's share of
  the heads (2 of 4 q heads, the 1 of 2 kv heads they read).
* The rule's scope (``embed_split`` / ``embed_whole`` on an
  ``AbstractMesh``): "embed" maps to "data" only where the batch axes do
  not divide the batch, only inside the block.
* The three cells of ``long_500k`` whose batch of 1 idled "data" (zamba2,
  seamless, xLSTM) through both dry-run CLIs on the 16 x 16 mesh ("fsdp"):
  the port's FLOPs between the model's useful FLOPs a chip and 1.1 x the
  reference's (its HLO walk plus the fused dots that the walk misses:
  ``tests/dryrun_flops_by_op.py``'s ``ref_ops``), its collective bytes at
  most 10 x the reference's, arguments and aliases within 1 %.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_layout_dist import _run
from test_torch_sharded_decode import _reference

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
# (prompt, cache slots, encoder frames); the batch is 1
CASES = {"qwen3-1.7b": (4, 12, 0), "zamba2-7b": (16, 20, 0),
         "seamless-m4t-large-v2": (4, 12, 8), "xlstm-125m": (4, 0, 0)}
# K7 calls (q heads, kv heads) on each rank: the reduced configs' 4 q heads
# over 2 kv heads, split over 2 data ranks
K7_SHARE = [2, 1]


@pytest.mark.parametrize("arch", sorted(CASES))
def test_batch1_decode_matches_one_device(arch, tmp_path):
    want, one, _, data = _reference(arch, batch=1, case=CASES[arch])
    torch.save(data, tmp_path / "decode_in.pt")
    for r, res in enumerate(_run(f"decode:{arch}", tmp_path)):
        assert res["bad"] == [], (r, res["bad"][:5])
        for step, (got, w, o) in enumerate(zip(res["logits"], want, one)):
            got = np.asarray(got, np.float32)
            np.testing.assert_allclose(got, o, atol=TOL, rtol=TOL, err_msg=f"rank {r} {step}")
            np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL, err_msg=f"rank {r} {step}")
        shards = [s for s in res["data_params"] if len(s) == 2]
        assert shards, res["data_params"]
        smallest = min(int(np.prod(s)) for s in shards)
        gathers = [shape for kind, axis, shape in res["collectives"]
                   if kind == "all-gather" and axis == "data"]
        for shape in gathers:
            assert tuple(shape) not in map(tuple, shards), (r, shape, shards)
            assert int(np.prod(shape)) < smallest, (r, shape, smallest)
        if arch == "xlstm-125m":
            assert res["k7_calls"] == []
        else:
            assert res["k7_calls"] and all(c == K7_SHARE for c in res["k7_calls"]), \
                (r, res["k7_calls"])


# --------------------------------------------------------------- the rule
@pytest.mark.parametrize("shape,axes,batch,want", [
    ((16, 16), ("data", "model"), 1, "data"),
    ((16, 16), ("data", "model"), 32, None),
    ((2, 16, 16), ("pod", "data", "model"), 16, "data"),
    ((2, 16, 16), ("pod", "data", "model"), 64, None),
    (None, None, 1, None)])
def test_embed_split_scopes_the_rule(shape, axes, batch, want):
    """``embed_split`` maps "embed" to "data" (FSDP's axis, not "pod") only
    where the batch axes do not divide the batch, only inside its block
    (and not inside ``embed_whole``), and never without a mesh."""
    from repro_torch.models import partitioning as pt

    mesh = None if shape is None else pt.AbstractMesh(shape, axes)
    with pt.use_mesh(mesh):
        with pt.embed_split(batch):
            assert pt.spec("embed")[0] == want
            assert pt.split_axes() == (() if want is None else (want,))
            with pt.embed_whole():
                assert pt.spec("embed")[0] is None and pt.split_axes() == ()
            assert pt.spec("embed")[0] == want
        assert pt.spec("embed")[0] is None


# ------------------------------------------------------------- the dry run
CELLS = ("zamba2-7b:long_500k", "seamless-m4t-large-v2:long_500k", "xlstm-125m:long_500k")
FLOPS_LIMIT = 1.1          # x the reference's walk plus its fused dots
COLLECTIVE_LIMIT = 10.0    # x the reference's collective bytes


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu")


def _call(args, timeout: int) -> str:
    res = subprocess.run([sys.executable, *args], cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def _artifact(out: Path, cell: str) -> dict:
    arch, shape = cell.split(":")
    return json.loads((out / f"{arch}__{shape}__16x16.json").read_text())


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """(the reference's artifacts, the port's, the reference's walk plus
    fused-dot FLOPs by cell), the CLIs and the per-op walks run at once."""
    ref, port = tmp_path_factory.mktemp("b1_ref"), tmp_path_factory.mktemp("b1_port")
    cells = ",".join(CELLS)
    jobs = [(["-m", "repro.launch.dryrun", "--cells", cells, "--out", str(ref)], 600),
            (["-m", "repro_torch.launch.dryrun", "--cells", cells, "--device", "cpu",
              "--out", str(port)], 600)]
    jobs += [([str(ROOT / "tests" / "dryrun_flops_by_op.py"), "ref", c], 600) for c in CELLS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        outs = list(pool.map(lambda job: _call(*job), jobs))
    walks = {}
    for c, out in zip(CELLS, outs[2:]):
        line = json.loads(out.strip().splitlines()[-1])
        walks[c] = line["flops"] + line["fused_flops"]
    return ({c: _artifact(ref, c) for c in CELLS}, {c: _artifact(port, c) for c in CELLS},
            walks)


@pytest.mark.parametrize("cell", CELLS)
def test_batch1_dryrun_matches_the_reference(dryruns, cell):
    refs, ports, walks = dryruns
    want, got = refs[cell], ports[cell]
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert abs(got[key] - want[key]) <= 0.01 * want[key], (key, got[key], want[key])
    useful = got["roofline"]["model_flops"] / got["chips"]
    assert useful <= got["hlo_flops"] <= FLOPS_LIMIT * walks[cell], \
        (useful, got["hlo_flops"], walks[cell])
    assert got["collective_bytes"] <= COLLECTIVE_LIMIT * want["collective_bytes"], \
        (got["collective_bytes"], want["collective_bytes"])
