"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<mix>.json``) and own
parameters (``cells/<cell>.json``), and each per-layer metric's reader
(``metrics/<metric>.py``).  A later cell, mix or metric is a new file and a
new entry; nothing here needs an edit for it."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: Mapping, name: str) -> Mapping:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


@dataclasses.dataclass
class Cell:
    """One cell: its entry, configuration, mix and parameters."""
    name: str
    entry: Mapping
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    params: Dict[str, Any]

    @property
    def deployment(self) -> Dict[str, Any]:
        return self.config["deployment"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    w = workload(bench, name)
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    here = root / "bench"
    return Cell(name, w,
                json.loads((root / cfg_entry["file"]).read_text()),
                json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
                json.loads((here / "cells" / f"{name}.json").read_text()))


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(trace) -> float | None`` of ``metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: Mapping, cell: str, group: str) -> List[Mapping]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without ``workloads``, and those whose ``workloads`` name it (a
    per-layer metric without ``workloads`` goes where its end-to-end metric
    does)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(m: Mapping) -> bool:
        return cell in m["workloads"] if "workloads" in m else True

    out = [m for m in bench[group] if reports(m)]
    if group == "per_layer":
        out = [m for m in out if "workloads" in m or reports(e2e[m["moves"]])]
    return out
