"""Rank 0's accounting of an expert-parallel MoE block in a fake world.

``python tests/torch_moe_fake_world.py`` (with ``src`` on ``PYTHONPATH``)
starts a fake world of 16 ranks (``mesh.start_fake_world``), builds a (4,
4) ("data", "model") CPU mesh, places a reduced MoE block's weights as
``state_shardings`` places them in ``ep`` (experts over "data") and a
bf16 batch over "data" as FakeTensor shards, and runs ``moe_apply`` once
under ``hlo_analysis.analyze``.  It prints one JSON line: the analysis's
FLOPs and collectives, the FLOPs of the expert products (the ``bmm`` ops:
the shared MLP and the router are 2-D products) and the result bytes of
every all-gather.  ``tests/test_torch_moe_parallel.py`` runs it.
"""
from __future__ import annotations

import json
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


def main() -> None:
    start_fake_world(16)
    mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4), mesh_dim_names=("data", "model"))
    d, e, f = CFG.d_model, CFG.n_experts, CFG.moe_d_ff
    shapes = {"router": (d, e), "wi": (e, d, 2 * f), "wo": (e, f, d),
              "shared.wi": (d, 2 * f * CFG.n_shared_experts),
              "shared.wo": (f * CFG.n_shared_experts, d)}
    metas = {f"layers.0.moe.{n}": torch.empty(s, device="meta") for n, s in shapes.items()}
    shd = state_shardings(metas, mesh, "ep", "moe")

    def fake(shape, placed, dtype):
        local, _ = local_shape_and_offset(shape, mesh, placed)
        return DTensor.from_local(torch.empty(local, dtype=dtype), mesh, tuple(placed),
                                  shape=shape, stride=contiguous_strides(shape))

    expert_flops, gathers = [], []
    dispatch = hlo_analysis._Profile.__torch_dispatch__

    def watching(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        if out is NotImplemented or self.skip:
            return out
        if func is torch.ops.aten.bmm.default:
            expert_flops.append(flop_registry[func._overloadpacket](*args, out_val=out))
        elif func._overloadpacket.__name__ == "all_gather_into_tensor":
            gathers.append(out.numel() * out.element_size())
        return out

    hlo_analysis._Profile.__torch_dispatch__ = watching
    with FakeTensorMode(), use_mesh(mesh, {"experts": "data"}):
        p = {n: fake(s, shd[f"layers.0.moe.{n}"],
                     torch.float32 if n == "router" else torch.bfloat16)
             for n, s in shapes.items()}
        params = SimpleNamespace(router=p["router"], wi=p["wi"], wo=p["wo"],
                                 shared={"wi": p["shared.wi"], "wo": p["shared.wo"]})
        x = fake((B, S, d), (Shard(0), Replicate()), torch.bfloat16)
        prof = hlo_analysis.analyze(moe.moe_apply, params, x, CFG)
    print(json.dumps({"flops": prof["flops"], "collectives": prof["collectives"],
                      "expert_flops": float(sum(expert_flops)), "all_gather_sizes": gathers}))


if __name__ == "__main__":
    main()
