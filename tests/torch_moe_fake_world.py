"""Rank 0's accounting of an MoE block in a fake world.

``python tests/torch_moe_fake_world.py [ep|fsdp]`` (with ``src`` on
``PYTHONPATH``) starts a fake world of 16 ranks (``mesh.start_fake_world``),
builds a (4, 4) ("data", "model") CPU mesh, places a reduced MoE block's
weights as ``state_shardings`` places them and a bf16 batch over "data" as
FakeTensor shards, and runs ``moe_apply`` under ``hlo_analysis.analyze``:
``ep`` (the default) with 8 dispatch groups and the experts over "data",
once; ``fsdp`` without groups, once on a (8, 32) batch (a rank's 64
tokens, as many as d_model) and once on a (8, 1) decode step (2).  It
prints one JSON line: for each run the analysis's FLOPs and collectives,
the FLOPs of the expert products (the ``bmm`` ops: the shared MLP and the
router are 2-D products), the operand shapes of each ``bmm`` and ``mm``,
and the result bytes of every all-gather.
``tests/test_torch_moe_parallel.py`` runs it.
"""
from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import start_fake_world
from repro_torch.launch.shardings import state_shardings
from repro_torch.models import moe
from repro_torch.models.partitioning import contiguous_strides, local_shape_and_offset, use_mesh

CFG = SimpleNamespace(d_model=64, n_experts=6, top_k=2, d_ff=128, moe_d_ff=32,
                      n_shared_experts=1, capacity_factor=1.0, renorm_topk=True,
                      moe_dispatch_groups=8)
B, S = 8, 32


def main(mode: str) -> None:
    start_fake_world(16)
    mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4), mesh_dim_names=("data", "model"))
    d, e, f = CFG.d_model, CFG.n_experts, CFG.moe_d_ff
    shapes = {"router": (d, e), "wi": (e, d, 2 * f), "wo": (e, f, d),
              "shared.wi": (d, 2 * f * CFG.n_shared_experts),
              "shared.wo": (f * CFG.n_shared_experts, d)}
    metas = {f"layers.0.moe.{n}": torch.empty(s, device="meta") for n, s in shapes.items()}
    shd = state_shardings(metas, mesh, mode, "moe")

    def fake(shape, placed, dtype):
        local, _ = local_shape_and_offset(shape, mesh, placed)
        return DTensor.from_local(torch.empty(local, dtype=dtype), mesh, tuple(placed),
                                  shape=shape, stride=contiguous_strides(shape))

    log = {}
    dispatch = hlo_analysis._Profile.__torch_dispatch__

    def watching(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        if out is NotImplemented or self.skip:
            return out
        if func in (torch.ops.aten.bmm.default, torch.ops.aten.mm.default):
            name = func._overloadpacket.__name__
            log[name].append([list(a.shape) for a in args[:2]])
            if name == "bmm":
                log["expert_flops"] += flop_registry[func._overloadpacket](*args, out_val=out)
        elif func._overloadpacket.__name__ == "all_gather_into_tensor":
            log["all_gather_sizes"].append(out.numel() * out.element_size())
        return out

    hlo_analysis._Profile.__torch_dispatch__ = watching
    cfg = CFG if mode == "ep" else SimpleNamespace(**{**vars(CFG), "moe_dispatch_groups": 0})
    runs = []
    with FakeTensorMode(), use_mesh(mesh, {"experts": "data"} if mode == "ep" else None):
        p = {n: fake(s, shd[f"layers.0.moe.{n}"],
                     torch.float32 if n == "router" else torch.bfloat16)
             for n, s in shapes.items()}
        params = SimpleNamespace(router=p["router"], wi=p["wi"], wo=p["wo"],
                                 shared={"wi": p["shared.wi"], "wo": p["shared.wo"]})
        for seq in (S,) if mode == "ep" else (S, 1):
            log.update(bmm=[], mm=[], expert_flops=0.0, all_gather_sizes=[])
            x = fake((B, seq, d), (Shard(0), Replicate()), torch.bfloat16)
            prof = hlo_analysis.analyze(moe.moe_apply, params, x, cfg)
            runs.append({"seq": seq, "flops": prof["flops"], "collectives": prof["collectives"],
                         **log})
    print(json.dumps(runs))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "ep")
