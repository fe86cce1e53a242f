"""A whole run at a tiny size on the CPU, past the harness's look for a
card: the result line, the per-layer readers, and the controls, which the
check has to fail."""
import json

import pytest
import torch

from bench import run as bench_run
from bench.spec import ROOT
from bench.tiny import LIMITS, tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 99


def run_tiny(mix, trace=False, control=False, seconds=0.6, **params):
    cell, arch = tiny_cell(mix, **params)
    return bench_run.run_cell(cell, BENCH, SEED, seconds, trace, torch.device("cpu"), arch=arch,
                              limits=LIMITS, control=control)


@pytest.mark.parametrize("mix,hit", [("cctv", (80.0, 96.0)), ("fresh", (0.0, 0.0))])
def test_traced_run_is_correct_and_reads_its_layers(mix, hit):
    res = run_tiny(mix, trace=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res["checks"])[:3] == ["reuse_wrong", "token_gap", "logit_err"]
    assert res["checks"]["reuse_wrong"]["value"] == 0
    m = res["metrics"]
    assert hit[0] <= m["hit_share"]["value"] <= hit[1]
    for name in ("route_ms", "query_ms", "insert_ms", "exec_ms", "mfu"):
        assert m[name]["value"] > 0
    # no card: the device readers find nothing and are left out
    assert not {"k6_roofline", "k1_roofline", "device_idle"} & set(m)
    assert list(res)[-1] == "checks"


def test_untraced_run_reports_the_end_to_end_metrics():
    res = run_tiny("cctv")
    assert res["correct"]
    assert list(res["metrics"]) == ["tasks_per_s", "task_p95_ms", "setup_s"]
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["count"] == 1


def test_the_controls_fail_the_check():
    """The reference one precision down in the program's place: the reuse
    layer on TF32-rounded inputs, the model's products in float8."""
    res = run_tiny("cctv", control=True)
    c = res["checks"]
    assert c["control_reuse_wrong"]["value"] > LIMITS["reuse_wrong"]
    assert c["control_token_gap"]["value"] > LIMITS["token_gap"]
    assert c["control_logit_err"]["value"] > LIMITS["logit_err"]
    assert res["correct"]


def test_refuses_debug_switches(monkeypatch, capsys):
    monkeypatch.setattr(bench_run, "pin_caches", lambda root: None)
    monkeypatch.setenv("RESERVOIR_SANITIZE", "1")
    assert bench_run.main(["--workload", "qwen3-1.7b.cctv", "--seed", "1", "--seconds", "1"]) == 2
    assert "RESERVOIR_SANITIZE" in capsys.readouterr().err


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(bench_run, "pin_caches", lambda root: None)
    monkeypatch.delenv("RESERVOIR_SANITIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--workload", "qwen3-1.7b.cctv", "--seed", "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
