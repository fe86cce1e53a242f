"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

The twin of tests/test_dryrun_cli.py::test_dryrun_cell_compiles: one cell
through the CLI as a subprocess, with fake CPU tensors (``--device cpu``:
this host's PyTorch has no CUDA, which DTensor's redistribute of fake CUDA
tensors needs) in a fake world of 256 ranks.  Then parity with the
reference: the reference's CLI (``repro.launch.dryrun``, XLA on 512 host
devices) and the port's on the same cells, xlstm-125m decode_32k and
qwen3-1.7b's four cells on the 16 x 16 mesh.  Both hold the same shards of
the same leaves: argument and alias bytes within 1 %.  A decode cell's
FLOPs are within 5 % of the reference's; a train or prefill cell's lie
between the model's useful FLOPs a chip and 1.05 x the reference's (K6
counts the causal pairs it computes, the reference's HLO the masked dots
too).  Each subprocess has its own time limit.  An MoE cell of its own,
qwen2-moe decode_32k in ``ep`` with 16 dispatch groups (the reference's
optimized layout: each data rank routes its own groups, tokens reach their
experts by all-to-all), through both CLIs: arguments and aliases within
1 %, FLOPs between the model's useful FLOPs a chip and 1.5 x the
reference's, an all-to-all among the port's collectives; and qwen2-moe's
prefill_32k and decode_32k in ``fsdp`` without dispatch groups (every
token routed on every rank, each rank's experts over its chunk of their
hidden), held to the same limits.  A cell whose q
heads 16 does not divide, gemma-2b prefill_32k (8 heads, 1 kv head: one
head on ranks 0-7 of "model", none on 8-15), through both CLIs: arguments
and aliases within 1 %, FLOPs between the model's useful FLOPs a chip and
1.5 x the reference's.  A cell of zamba2, whose Mamba2 layers split their
112 heads over "model" (7 a rank), decode_32k through both CLIs: the same
limits (the reference's CLI takes ~6 s here, the port's ~12 s, each held
to 600).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("xlstm-125m:decode_32k", "qwen3-1.7b:train_4k", "qwen3-1.7b:prefill_32k",
         "qwen3-1.7b:decode_32k", "qwen3-1.7b:long_500k")
# the reference's artifact keys, less what XLA's compile alone gives
KEYS = {"arch", "shape", "mesh", "chips", "mode", "moment_dtype", "kind", "lower_s",
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "alias_size_in_bytes", "xla_flops_raw", "xla_bytes_raw", "analysis_s", "hlo_flops",
        "hlo_bytes", "collectives", "collective_counts", "collective_bytes", "roofline"}


def _cli(module: str, args, out: Path, timeout: int):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-m", module, *args, "--out", str(out)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]


def _artifact(out: Path, cell: str) -> dict:
    arch, shape = cell.split(":")
    return json.loads((out / f"{arch}__{shape}__16x16.json").read_text())


def test_dryrun_cell_lowers(tmp_path):
    _cli("repro_torch.launch.dryrun", ["--arch", "xlstm-125m", "--shape", "decode_32k",
                                       "--device", "cpu"], tmp_path, 600)
    res = _artifact(tmp_path, "xlstm-125m:decode_32k")
    assert KEYS <= set(res) and "compile_s" not in res
    assert res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["hlo_flops"] > 0 and res["hlo_bytes"] > 0
    assert res["temp_size_in_bytes"] > 0
    roof = res["roofline"]
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["hw"] == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's artifacts dir, the port's), each CLI run once."""
    ref, port = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    _cli("repro.launch.dryrun", ["--cells", ",".join(CELLS)], ref, 600)
    _cli("repro_torch.launch.dryrun", ["--cells", ",".join(CELLS), "--device", "cpu"], port,
         1200)
    return ref, port


@pytest.mark.parametrize("cell", CELLS)
def test_dryrun_matches_the_reference(cell, both):
    want, got = (_artifact(d, cell) for d in both)
    assert KEYS <= set(got)
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert abs(got[key] - want[key]) <= 0.01 * want[key], (key, got[key], want[key])
    if got["kind"] == "decode":
        assert abs(got["hlo_flops"] / want["hlo_flops"] - 1) <= 0.05, \
            (got["hlo_flops"], want["hlo_flops"])
    else:
        useful = got["roofline"]["model_flops"] / got["chips"]
        assert useful <= got["hlo_flops"] <= 1.05 * want["hlo_flops"], \
            (useful, got["hlo_flops"], want["hlo_flops"])


MOE_CELL = "qwen2-moe-a2.7b:decode_32k"
MOE_ARGS = ["--mode", "ep", "--override", "moe_dispatch_groups=16"]


@pytest.fixture(scope="module")
def moe_both(tmp_path_factory):
    """(the reference's artifact, the port's) of MOE_CELL."""
    ref, port = tmp_path_factory.mktemp("moe_ref"), tmp_path_factory.mktemp("moe_port")
    _cli("repro.launch.dryrun", ["--cells", MOE_CELL, *MOE_ARGS], ref, 600)
    _cli("repro_torch.launch.dryrun", ["--cells", MOE_CELL, *MOE_ARGS, "--device", "cpu"],
         port, 600)
    return _artifact(ref, MOE_CELL), _artifact(port, MOE_CELL)


def test_moe_dryrun_matches_the_reference(moe_both):
    want, got = moe_both
    assert got["mode"] == want["mode"] == "ep"
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert abs(got[key] - want[key]) <= 0.01 * want[key], (key, got[key], want[key])
    useful = got["roofline"]["model_flops"] / got["chips"]
    assert useful <= got["hlo_flops"] <= 1.5 * want["hlo_flops"], \
        (useful, got["hlo_flops"], want["hlo_flops"])
    assert got["collectives"].get("all-to-all", 0) > 0, got["collectives"]


FSDP_MOE_CELLS = ("qwen2-moe-a2.7b:prefill_32k", "qwen2-moe-a2.7b:decode_32k")


@pytest.fixture(scope="module")
def fsdp_moe_both(tmp_path_factory):
    """(the reference's artifacts, the port's) of FSDP_MOE_CELLS, no overrides."""
    ref, port = tmp_path_factory.mktemp("fsdp_moe_ref"), tmp_path_factory.mktemp("fsdp_moe_port")
    _cli("repro.launch.dryrun", ["--cells", ",".join(FSDP_MOE_CELLS)], ref, 600)
    _cli("repro_torch.launch.dryrun", ["--cells", ",".join(FSDP_MOE_CELLS), "--device", "cpu"],
         port, 600)
    return ({c: _artifact(ref, c) for c in FSDP_MOE_CELLS},
            {c: _artifact(port, c) for c in FSDP_MOE_CELLS})


@pytest.mark.parametrize("cell", FSDP_MOE_CELLS)
def test_fsdp_moe_dryrun_matches_the_reference(fsdp_moe_both, cell):
    want, got = (d[cell] for d in fsdp_moe_both)
    assert got["mode"] == want["mode"] == "fsdp"
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert abs(got[key] - want[key]) <= 0.01 * max(want[key], 1), (key, got[key], want[key])
    useful = got["roofline"]["model_flops"] / got["chips"]
    assert useful <= got["hlo_flops"] <= 1.5 * want["hlo_flops"], \
        (useful, got["hlo_flops"], want["hlo_flops"])


HEAD_CELL = "gemma-2b:prefill_32k"


@pytest.fixture(scope="module")
def head_both(tmp_path_factory):
    """(the reference's artifact, the port's) of HEAD_CELL."""
    ref, port = tmp_path_factory.mktemp("head_ref"), tmp_path_factory.mktemp("head_port")
    _cli("repro.launch.dryrun", ["--cells", HEAD_CELL], ref, 600)
    _cli("repro_torch.launch.dryrun", ["--cells", HEAD_CELL, "--device", "cpu"], port, 600)
    return _artifact(ref, HEAD_CELL), _artifact(port, HEAD_CELL)


def test_uneven_heads_dryrun_matches_the_reference(head_both):
    want, got = head_both
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert abs(got[key] - want[key]) <= 0.01 * max(want[key], 1), (key, got[key], want[key])
    useful = got["roofline"]["model_flops"] / got["chips"]
    assert useful <= got["hlo_flops"] <= 1.5 * want["hlo_flops"], \
        (useful, got["hlo_flops"], want["hlo_flops"])


MAMBA_CELL = "zamba2-7b:decode_32k"


@pytest.fixture(scope="module")
def mamba_both(tmp_path_factory):
    """(the reference's artifact, the port's) of MAMBA_CELL."""
    ref, port = tmp_path_factory.mktemp("mamba_ref"), tmp_path_factory.mktemp("mamba_port")
    _cli("repro.launch.dryrun", ["--cells", MAMBA_CELL], ref, 600)
    _cli("repro_torch.launch.dryrun", ["--cells", MAMBA_CELL, "--device", "cpu"], port, 600)
    return _artifact(ref, MAMBA_CELL), _artifact(port, MAMBA_CELL)


def test_mamba_heads_dryrun_matches_the_reference(mamba_both):
    want, got = mamba_both
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert abs(got[key] - want[key]) <= 0.01 * max(want[key], 1), (key, got[key], want[key])
    useful = got["roofline"]["model_flops"] / got["chips"]
    assert useful <= got["hlo_flops"] <= 1.5 * want["hlo_flops"], \
        (useful, got["hlo_flops"], want["hlo_flops"])
