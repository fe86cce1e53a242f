"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name; a new cell is new files and entries only."""
import json
import shutil

import pytest

from bench import spec
from bench.spec import NAME, ROOT, UNIT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys(group, keys):
    for e in BENCH[group]:
        assert set(e) - {"workloads"} == keys, e["name"]


def test_names_and_units_use_allowed_characters():
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[g]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for g in ("end_to_end", "per_layer") for m in BENCH[g]]
    assert all(UNIT.match(u) for u in units)
    for g in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[g]}) == len(BENCH[g])
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"router", "replica and store", "executor and model", "kernels",
                           "device"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["arch"] == c.entry["config"]
    for key in ("clients", "warm_rounds", "max_rounds", "check_tasks", "capture_share",
                "judge_queries"):
        assert key in c.params
    assert set(c.config["check"]) == {"reuse_wrong", "token_gap", "logit_err"}
    for m in spec.metrics_of(BENCH, cell, "per_layer"):
        assert callable(spec.metric_reader(m["name"]))
    assert [m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")] == [
        "tasks_per_s", "task_p95_ms", "setup_s"]


def test_config_files_state_what_is_run():
    from repro_torch.configs import get_arch

    from bench.cell import SIZE_KEYS, arch_sizes
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        program = arch_sizes(get_arch(cfg["arch"]))
        assert {k: cfg[k] for k in SIZE_KEYS} == program
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])


def test_a_new_cell_needs_no_edit(tmp_path):
    """A cell, its mix and its parameters added as new files and a new
    entry: found by name, and the old files untouched."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench["workloads"].append({"name": "qwen3-1.7b.half", "config": "qwen3-1.7b",
                               "traffic": "half", "chips": 1, "why": "half the tasks novel"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "bench/traffic/cctv.json").read_text())
    (root / "bench/traffic/half.json").write_text(json.dumps(dict(mix, novel_share=0.5)))
    cellp = json.loads((root / "bench/cells/qwen3-1.7b.cctv.json").read_text())
    (root / "bench/cells/qwen3-1.7b.half.json").write_text(json.dumps(dict(cellp, clients=64)))
    c = spec.load_cell("qwen3-1.7b.half", root)
    assert c.traffic["novel_share"] == 0.5 and c.params["clients"] == 64
    assert [m["name"] for m in spec.metrics_of(bench, "qwen3-1.7b.half", "per_layer")] == [
        m["name"] for m in bench["per_layer"]]
    after = {p.relative_to(root): p.read_bytes() for p in (root / "bench").rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before
