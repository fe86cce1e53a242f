"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake mesh.

Port of ``repro/launch/dryrun.py``.  For each cell this builds the real step
function (the train step with its optimizer, or ``prefill`` / ``decode_step``
with KV caches), places its inputs on the production mesh as DTensors of
FakeTensor shards (shapes, dtypes and devices without storage) and runs it
once under ``FakeTensorMode`` in a fake world of 256 or 512 ranks
(``mesh.start_fake_world``).  Nothing runs on a card, nothing is allocated
and no weight exists: the model is built on ``"meta"``.  The reference
lowers and compiles with XLA instead; here one eager run of rank 0 is the
trace, and ``hlo_analysis.analyze`` profiles it per device:

  * memory: per-device argument / output / temp / alias bytes (fits check)
  * FLOPs and an HBM-bytes proxy for the roofline terms
  * collective bytes by kind

These are static figures of one rank's ops, not measurements of a card.
Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(a failed cell writes ``<tag>.json.err``), with the reference's keys;
``lower_s`` is the fake run's seconds and there is no ``compile_s``
(nothing is compiled).  ``xla_flops_raw`` / ``xla_bytes_raw``, XLA's own
figures that count a loop body once, equal the walk's here (eager code
runs every iteration).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
         [--cells a:s,a:s,...] [--device cpu]

``--device`` is the device type of the fake tensors and of the mesh:
``cuda`` by default (what the port would run on), ``cpu`` where the host
has no CUDA build of PyTorch (DTensor's redistribute of fake CUDA tensors
needs one).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Optional

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import ALL_SHAPES, ARCHS, get_arch, get_shape
from ..models import build_model
from ..models.partitioning import contiguous_strides, local_shape_and_offset, use_mesh
from ..training import OptimizerConfig, adamw_init, make_train_step
from . import hlo_analysis
from . import shardings as shl
from .mesh import make_production_mesh, start_fake_world

# NVIDIA H100 SXM5 datasheet figures (not measurements): dense bf16 tensor
# core FLOP/s, HBM3 bytes/s, and NVLink 4 bytes/s in one direction.  A 16 x
# 16 mesh spans 32 nodes of 8 cards, so most collectives cross the network
# between nodes, which is slower than NVLink: the collective term below is
# a lower bound.
HW = {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9}


def _serve_params(model: nn.Module, cfg) -> dict:
    """Serving params are the bf16 inference checkpoint (no f32 master):
    halves FSDP gather traffic + weight HBM for prefill/decode cells.  As
    the reference casts its f32 leaves of rank >= 2, and its leaves stack a
    layer group's on leading axes (each numeric part of a port name is one:
    ``layers.3.ln1`` is 2-D there), the norm scales and routers of the
    layers are cast too; the model reads them as f32 where it needs them."""
    dt = getattr(torch, cfg.dtype)
    out = {}
    for name, p in model.named_parameters():
        rank = p.dim() + sum(part.isdigit() for part in name.split("."))
        out[name] = p.detach().to(dt) if p.dtype == torch.float32 and rank >= 2 else p.detach()
    return out


def optimized_settings(arch_cfg, shape_kind: str = "prefill"):
    """Beyond-paper optimized defaults found by the §Perf hillclimb.

    Blocked attention is applied to PREFILL cells only: §Perf measured small
    regressions on some train cells (the scan-attention backward re-reads
    block buffers), so training keeps the naive path by default.
    """
    ov = {}
    mode = "fsdp"
    if arch_cfg.family == "ssm":
        ov.update(mlstm_impl="chunked", scan_chunk=64)
    elif shape_kind == "prefill":
        ov["attn_impl"] = "blocked"
    if arch_cfg.n_experts:
        mode = "ep"
        ov["moe_dispatch_groups"] = 16
    return ov, mode


def _microbatches(arch_cfg, shape) -> int:
    if shape.kind != "train":
        return 1
    # keep per-device live activations ~O(GB): bigger models -> more splits
    if arch_cfg.d_model >= 3584:
        return 8
    if arch_cfg.d_model >= 2048:
        return 4
    return 2


def _fake_shards(tree, shardings, mesh, device: str):
    """A tree of meta tensors (or ``input_specs``' (shape, dtype) pairs) as
    DTensors on ``mesh`` with the placements of ``shardings``, each holding
    only this rank's shard as a FakeTensor on ``device`` (call inside
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    def place(leaf, placed):
        shape, dtype = (leaf if isinstance(leaf, tuple) else (tuple(leaf.shape), leaf.dtype))
        local, _ = local_shape_and_offset(shape, mesh, placed)
        return DTensor.from_local(torch.empty(local, dtype=dtype, device=device), mesh,
                                  tuple(placed), shape=tuple(shape),
                                  stride=contiguous_strides(shape))

    return {k: _fake_shards(v, shardings[k], mesh, device) if isinstance(v, dict)
            else place(v, shardings[k]) for k, v in tree.items()}


class _Serve(nn.Module):
    """``model.prefill`` or ``model.decode_step`` as a module call, so that
    ``torch.func.functional_call`` runs it on the placed parameters."""

    def __init__(self, model: nn.Module, kind: str):
        super().__init__()
        self.model, self.kind = model, kind

    def forward(self, *args):
        fn = self.model.prefill if self.kind == "prefill" else self.model.decode_step
        return fn(*args)


def lower_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
               mode: str = "fsdp", moment_dtype: str = "float32",
               rules: Optional[dict] = None,
               microbatches: Optional[int] = None,
               overrides: Optional[dict] = None, device: str = "cuda") -> dict:
    """Trace one cell on the production mesh (the fake world must hold it)
    and return its artifact (without the roofline)."""
    cfg = get_arch(arch_name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    ocfg = OptimizerConfig(moment_dtype=moment_dtype)
    if mode == "ep" and rules is None:
        rules = {"experts": "data"}  # tokens move, expert weights stay
    result = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
        "mode": mode, "moment_dtype": moment_dtype,
        "kind": shape.kind,
    }
    model = build_model(cfg, device="meta", trainable=shape.kind == "train")
    # no weight is drawn or allocated; what the model makes itself (caches,
    # positions) is made on the fake tensors' device
    model.device = torch.device(device)
    # every input's global shape and dtype, as meta tensors
    batch_specs = model.input_specs(shape)
    if shape.kind == "train":
        params = dict(model.named_parameters())
        inputs = {"params": params, "opt": adamw_init(params, ocfg)}
        shd = shl.state_shardings(inputs, mesh, mode, cfg.family)
    else:
        inputs = {"params": _serve_params(model, cfg)}
        shd = {"params": shl.state_shardings(inputs["params"], mesh, mode, cfg.family)}
        if shape.kind == "decode":
            inputs["cache"] = model.cache_specs(shape.global_batch, shape.seq_len)
            shd["cache"] = shl.cache_shardings(inputs["cache"], mesh, cfg.family)
    with FakeTensorMode(), use_mesh(mesh, rules), implicit_replication():
        batch = _fake_shards(batch_specs, shl.batch_shardings(batch_specs, mesh), mesh, device)
        placed = _fake_shards(inputs, shd, mesh, device)
        if shape.kind == "train":
            mb = microbatches or _microbatches(cfg, shape)
            result["microbatches"] = mb
            step = make_train_step(model, ocfg, microbatches=mb,
                                   grad_shardings=shd["params"], compute_dtype=cfg.dtype)
            prof = hlo_analysis.analyze(step, placed, batch, donate=[placed])
        else:
            call = _Serve(model, shape.kind)

            def serve_step(params, *args):
                with torch.no_grad():
                    return torch.func.functional_call(
                        call, {f"model.{n}": t for n, t in params.items()}, args)

            if shape.kind == "prefill":
                prof = hlo_analysis.analyze(serve_step, placed["params"], batch, shape.seq_len)
            else:
                # the last position: the cache is full, as the reference's
                # traced position counts it
                prof = hlo_analysis.analyze(serve_step, placed["params"], batch["tokens"],
                                            placed["cache"], shape.seq_len - 1,
                                            donate=[placed["cache"]])
    result["lower_s"] = round(prof["seconds"], 2)
    for attr in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                 "alias_size_in_bytes"):
        result[attr] = prof[attr]
    result["xla_flops_raw"] = prof["flops"]
    result["xla_bytes_raw"] = prof["bytes"]
    result["analysis_s"] = 0.0    # the profile is taken during the run itself
    result["hlo_flops"] = prof["flops"]
    result["hlo_bytes"] = prof["bytes"]
    result["collectives"] = prof["collectives"]
    result["collective_counts"] = prof["collective_counts"]
    result["collective_bytes"] = prof["collective_bytes"]
    return result


def roofline_terms(result: dict, model_flops: float) -> dict:
    chips = result["chips"]
    # the analysis counts each rank's own ops: PER-DEVICE flops
    compute_s = result["hlo_flops"] / HW["peak_flops_bf16"]
    memory_s = result["hlo_bytes"] / HW["hbm_bw"]
    coll_s = result["collective_bytes"] / HW["nvlink_bw"]
    dominant = max(
        (("compute", compute_s), ("memory", memory_s), ("collective", coll_s)),
        key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_frac": (model_flops / chips) / max(result["hlo_flops"], 1.0),
        "hw": dict(HW),
    }


def model_flops_for(cfg, shape) -> float:
    n = cfg.flops_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # one decoded token per row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", type=str, default=None,
                    help="comma-separated arch:shape pairs")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mode", choices=("tp", "fsdp", "ep"), default="fsdp")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig overrides, e.g. attn_impl=blocked")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the §Perf hillclimb's per-arch settings")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device type of the fake tensors and the mesh")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        key, val = ov.split("=", 1)
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        overrides[key] = val

    cells = []
    if args.all:
        for a in ARCHS:
            for s in ALL_SHAPES:
                cells.append((a, s.name))
    elif args.cells:
        for c in args.cells.split(","):
            a, s = c.split(":")
            cells.append((a, s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all or --cells"
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    start_fake_world(512 if any(meshes) else 256)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{get_arch(arch).name.replace('/', '_')}__{shape}__{'2x16x16' if mp else '16x16'}"
            out_path = os.path.join(args.out, tag + ".json")
            print(f"=== {tag} ===", flush=True)
            try:
                cell_over, cell_mode = dict(overrides), args.mode
                if args.optimized:
                    auto_over, auto_mode = optimized_settings(
                        get_arch(arch), get_shape(shape).kind)
                    cell_over = {**auto_over, **cell_over}
                    if auto_mode != "fsdp":
                        cell_mode = auto_mode
                res = lower_cell(arch, shape, multi_pod=mp, mode=cell_mode,
                                 moment_dtype=args.moment_dtype,
                                 microbatches=args.microbatches,
                                 overrides=cell_over, device=args.device)
                res["roofline"] = roofline_terms(
                    res, model_flops_for(get_arch(arch), get_shape(shape)))
                with open(out_path, "w") as f:
                    json.dump(res, f, indent=1)
                print(f"    ok: lower={res['lower_s']}s "
                      f"dominant={res['roofline']['dominant']}", flush=True)
            except Exception as e:  # noqa: BLE001 — record, continue grid
                failures.append((tag, repr(e)))
                with open(out_path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"    FAILED: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall cells lowered OK")


if __name__ == "__main__":
    main()
