"""Rank 0's share of zamba2-7b's Mamba2 heads in a fake world.

``python tests/torch_mamba_fake_world.py`` (with ``src`` on ``PYTHONPATH``)
starts a fake world of 256 ranks (``mesh.start_fake_world``), builds the 16
x 16 ("data", "model") CPU mesh and, as FakeTensor shards placed by
``state_shardings`` ("fsdp") and ``cache_shardings``, runs on rank 0 one of
zamba2-7b's Mamba2 layers at published width (d_model 3584, 112 heads of
64, N = 64; 16 x 256 bf16 tokens) through ``ssm.mamba2_sharded``: forward
and backward, then a prefill that writes its caches and a decode step.  It
prints one JSON line: the size of the heads dim of every einsum with one
(``einsum_heads``), the shapes of every matrix product's operands and
output (``mm_operands``), the in_proj columns each scan holds (of the
weight, or of the product where a decode step moves that:
``in_proj_cols``), the all-to-all and all-reduce bytes, and the FLOPs of
the forward and backward.  ``tests/test_torch_mamba_split.py`` runs it.
"""
from __future__ import annotations

import json

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_arch
from repro_torch.device import generator
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import start_fake_world
from repro_torch.launch.shardings import batch_shardings, cache_shardings, state_shardings
from repro_torch.models import ssm
from repro_torch.models.partitioning import contiguous_strides, local_shape_and_offset, use_mesh

B, S = 16, 256
_MM = ("mm", "addmm", "bmm")


def main() -> None:
    start_fake_world(256)
    mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16), mesh_dim_names=("data", "model"))
    cfg = get_arch("zamba2-7b")
    shapes = {n: tuple(t.shape) for n, t in
              ssm.mamba2_init(generator(torch.device("meta"), 0), cfg, device="meta").items()}
    shapes["ln"] = (cfg.d_model,)
    name = {n: f"main.0.0.{'' if n == 'ln' else 'mamba.'}{n}" for n in shapes}
    shd = state_shardings({name[n]: torch.empty(s, device="meta") for n, s in shapes.items()},
                          mesh, "fsdp", cfg.family)
    st, cb = ssm.mamba2_state_shapes(cfg, B)
    cache_shd = cache_shardings({"ssm": torch.empty(st, device="meta"),
                                 "conv": torch.empty(cb, device="meta")}, mesh, cfg.family)
    x_shd = batch_shardings({"x": ((B, S, cfg.d_model), torch.bfloat16)}, mesh)["x"]

    def fake(shape, placed, dtype=torch.bfloat16):
        local, _ = local_shape_and_offset(shape, mesh, placed)
        return DTensor.from_local(torch.empty(local, dtype=dtype), mesh, tuple(placed),
                                  shape=shape, stride=contiguous_strides(shape))

    heads, mm, cols = [], [], []
    einsum, gate, step = torch.einsum, ssm.mamba2_gate, ssm.mamba2_decode_gate

    def logging_einsum(eq, *ops):
        lhs = eq.split("->")[0].split(",")
        heads.extend(int(t.shape[s.index("h")]) for s, t in zip(lhs, ops) if "h" in s)
        return einsum(eq, *ops)

    def logging(fn):
        def run(params, *args, **kw):
            w = params["in_proj"]
            cols.append(int((kw["proj"] if w is None else w).shape[-1]))
            return fn(params, *args, **kw)
        return run

    dispatch = hlo_analysis._Profile.__torch_dispatch__

    def watching(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        if out is not NotImplemented and not self.skip and \
                func._overloadpacket.__name__ in _MM:
            mm.extend([list(a.shape) for a in args if isinstance(a, torch.Tensor)]
                      + [list(out.shape)])
        return out

    torch.einsum, ssm.mamba2_gate, ssm.mamba2_decode_gate = \
        logging_einsum, logging(gate), logging(step)
    hlo_analysis._Profile.__torch_dispatch__ = watching
    with FakeTensorMode(), use_mesh(mesh):
        params = {n: fake(s, shd[name[n]], torch.float32).requires_grad_()
                  for n, s in shapes.items()}
        ln = params.pop("ln")
        x = fake((B, S, cfg.d_model), x_shd).requires_grad_()

        def train(params, ln, x):
            y = ssm.mamba2_sharded(params, ln, x, cfg, chunk=cfg.scan_chunk)
            y.sum().full_tensor().backward()

        prof = hlo_analysis.analyze(train, params, ln, x)
        caches = {k: fake(s, cache_shd[k], torch.float32) for k, s in (("ssm", st), ("conv", cb))}
        with torch.no_grad():
            ssm.mamba2_sharded(params, ln, x.detach(), cfg, chunk=cfg.scan_chunk, **caches)
            tok = fake((B, 1, cfg.d_model), x_shd)
            ssm.mamba2_sharded(params, ln, tok, cfg, step=True, **caches)
    print(json.dumps({"einsum_heads": sorted(set(heads)), "mm_operands": mm,
                      "in_proj_cols": sorted(set(cols)),
                      "all_to_all": prof["collectives"].get("all-to-all", 0.0),
                      "all_reduce": prof["collectives"].get("all-reduce", 0.0),
                      "flops": prof["flops"]}))


if __name__ == "__main__":
    main()
