"""A cell small enough for the CPU tests: the configuration's ``reduced()``
model of the port (float32), 3,000-entry stores, 160 clients (80 a replica,
so each replica's query takes the fused path), 16-token prompts."""
from __future__ import annotations

import json
from typing import Tuple

from bench.cell import arch_sizes
from bench.spec import ROOT, Cell

LIMITS = {"reuse_wrong": 0, "token_gap": 1e-3, "logit_err": 1e-3}   # float32 both sides


def tiny_cell(mix: str = "cctv", arch_name: str = "qwen3-1.7b", clients: int = 160,
              capacity: int = 3000, **params) -> Tuple[Cell, object]:
    from repro_torch.configs import get_arch
    arch = get_arch(arch_name).reduced()
    full = json.loads((ROOT / "bench" / "configs" / f"{arch_name}.json").read_text())
    dep = dict(full["deployment"], store_capacity=capacity, cs_capacity=256, prompt_tokens=16,
               bucket_cap=max(8, min(512, -(-4 * capacity // full["deployment"]["lsh"]
                                            ["num_buckets"]))))
    cfg = dict(arch_sizes(arch), arch=arch_name, deployment=dep, check=LIMITS)
    traffic = json.loads((ROOT / "bench" / "traffic" / f"{mix}.json").read_text())
    p = {"clients": clients, "warm_rounds": 2, "max_rounds": 400, "check_tasks": 16,
         "capture_share": 0.5, "judge_queries": 100000, **params}
    return Cell(f"tiny.{mix}", {"chips": 1}, cfg, traffic, p), arch
