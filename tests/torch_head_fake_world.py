"""Rank 0's share of split heads and of a split vocabulary in a fake world.

``python tests/torch_head_fake_world.py`` (with ``src`` on ``PYTHONPATH``)
starts a fake world of 256 ranks (``mesh.start_fake_world``), builds the 16
x 16 ("data", "model") CPU mesh and, as FakeTensor shards placed by
``state_shardings`` ("fsdp"), runs on rank 0: llama4's attention layer at
published width (d_model 5120, 40 q heads, 8 kv heads, head width 128; 16
x 256 bf16 tokens) forward and backward, and seamless's cross entropy
(``layers.ce_sum``: a replicated table of 256206 rows by 1024, 16 x 512
tokens) forward and backward.  It prints one JSON line: the q heads of
each K6 call (``k6_heads``), the local shape of every matrix product
(``mm_shapes``), the vocabulary columns of seamless's logits shard
(``max_vocab_cols``) and the all-to-all bytes.  ``tests/
test_torch_head_split.py`` runs it.
"""
from __future__ import annotations

import json

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import start_fake_world
from repro_torch.launch.shardings import state_shardings
from repro_torch.models import attention, layers
from repro_torch.models.partitioning import contiguous_strides, local_shape_and_offset, use_mesh

B, S, S_CE = 16, 256, 512
_MM = ("mm", "addmm", "bmm")


def main() -> None:
    start_fake_world(256)
    mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16), mesh_dim_names=("data", "model"))
    llama4, seamless = get_arch("llama4-maverick-400b-a17b"), get_arch("seamless-m4t-large-v2")
    d, hd = llama4.d_model, llama4.head_dim
    shapes = {"wq": (d, llama4.n_heads * hd), "wk": (d, llama4.n_kv_heads * hd),
              "wv": (d, llama4.n_kv_heads * hd), "wo": (llama4.n_heads * hd, d)}
    metas = {f"layers.0.attn.{n}": torch.empty(s, device="meta") for n, s in shapes.items()}
    metas["embed"] = torch.empty((seamless.vocab_size, seamless.d_model), device="meta")
    shd = state_shardings(metas, mesh, "fsdp", "dense")

    def fake(shape, placed, dtype=torch.bfloat16):
        local, _ = local_shape_and_offset(shape, mesh, placed)
        return DTensor.from_local(torch.empty(local, dtype=dtype), mesh, tuple(placed),
                                  shape=shape, stride=contiguous_strides(shape))

    heads, mm_shapes = [], []
    forward = flash_attention.forward

    def logging(q, *args, **kw):
        heads.append(int(q.shape[2]))
        return forward(q, *args, **kw)

    dispatch = hlo_analysis._Profile.__torch_dispatch__

    def watching(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        if out is not NotImplemented and not self.skip and _name(func) in _MM:
            mm_shapes.append(list(out.shape))
        return out

    flash_attention.forward = logging
    hlo_analysis._Profile.__torch_dispatch__ = watching
    rows = (Shard(0), Replicate())
    with FakeTensorMode(), use_mesh(mesh), implicit_replication():
        params = {n: fake(s, shd[f"layers.0.attn.{n}"]).requires_grad_()
                  for n, s in shapes.items()}
        x = fake((B, S, d), rows).requires_grad_()

        def attn(params, x):
            attention.attention_apply(params, x, llama4).sum().full_tensor().backward()

        attn_prof = hlo_analysis.analyze(attn, params, x)
        table = fake(tuple(metas["embed"].shape), shd["embed"]).requires_grad_()
        h = fake((B, S_CE, seamless.d_model), rows).requires_grad_()
        labels = fake((B, S_CE), rows, torch.long)
        cols = layers.vocab_logits(h, layers.at_use(table, h.dtype)).to_local().shape[-1]

        def ce(h, table):
            layers.ce_sum(h, labels, layers.at_use(table, h.dtype))[0].full_tensor().backward()

        ce_prof = hlo_analysis.analyze(ce, h, table)
    print(json.dumps({"k6_heads": sorted(set(heads)), "mm_shapes": mm_shapes,
                      "max_vocab_cols": int(cols),
                      "all_to_all": attn_prof["collectives"].get("all-to-all", 0.0),
                      "flops": [attn_prof["flops"], ce_prof["flops"]]}))


def _name(func) -> str:
    return func._overloadpacket.__name__


if __name__ == "__main__":
    main()
