"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro/launch/train.py``, with its flags and defaults.  Runs real
steps on the CUDA card (``main(argv, device="cpu")`` runs them on the CPU;
use ``--reduced`` there) for any of the 10 architectures: the model's
training construction (fp32 masters drawn from seed 0), AdamW with the
moment dtype and gradient compression asked for, microbatching, the
deterministic synthetic stream (tokens and labels, and a family's float
inputs: a vision model's patch embeddings, an encoder-decoder's frames),
and checkpoint/restart: with ``--ckpt-dir`` it resumes from the latest
checkpoint there and saves asynchronously every ``--ckpt-every`` steps.
It prints the reference's step lines.  As the reference does, it runs on
a host mesh (``launch/mesh.py::make_host_mesh``: every rank of the job in
(data, 1); a world of one when no process group was started) under
``use_mesh``: the state is distributed with ``state_shardings(..., "tp")``
placements (a checkpoint is restored with them), each batch with
``batch_shardings``, and the gradients are redistributed to the
parameters' placements (``grad_shardings``).  On a mesh of one rank
``distribute`` leaves the tensors plain, and the step runs without
DTensor's dispatch.

The random weights differ from the reference's (a torch generator against
a JAX key); a run that resumes from a checkpoint of the reference's state
(``convert.train_state_from_jax``, saved at step 0) takes the reference's
steps.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import ShapeSpec, get_arch
from ..device import DeviceLike, resolve_device
from ..models import build_model, use_mesh
from ..models.partitioning import whole
from ..training import (
    AsyncCheckpointer,
    OptimizerConfig,
    init_state,
    latest_step,
    make_train_step,
    restore,
)
from .mesh import make_host_mesh
from .shardings import batch_shardings, distribute, state_shardings


def synthetic_batch(model, cfg, shape: ShapeSpec, step: int,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Deterministic synthetic token stream (data pipeline stand-in): the
    reference's draws from ``np.random.default_rng(1234 + step)``, in the
    order of ``model.input_specs``, bit for bit: int32 inputs uniform over
    the vocabulary, float inputs (patch embeddings, frames) standard normal
    cast to their dtype and scaled by 0.02."""
    rng = np.random.default_rng(1234 + step)
    batch = {}
    for name, (shp, dtype) in model.input_specs(shape).items():
        if dtype == torch.int32:
            x = torch.from_numpy(rng.integers(0, cfg.vocab_size, shp).astype(np.int32))
        else:
            x = torch.from_numpy(rng.standard_normal(shp)).to(dtype) * 0.02
        batch[name] = x.to(device)
    return batch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> List[dict]:
    """Run the steps; returns one dict a step taken ("step", "loss",
    "grad_norm", "lr", and "ms": wall time of the step to its result)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, dev, seed=0, trainable=True)
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    ocfg = OptimizerConfig(lr=args.lr, moment_dtype=args.moment_dtype,
                           compress_grads=args.compress_grads, total_steps=args.steps)
    mesh = make_host_mesh(device=dev)
    ckpt = AsyncCheckpointer()

    with use_mesh(mesh):
        state = init_state(model, ocfg)
        shd = state_shardings(state, mesh, "tp", cfg.family)
        start_step = 0
        if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            restore(args.ckpt_dir, state, shardings=shd)
            start_step = int(whole(state["opt"]["step"]))
            print(f"resumed from step {start_step}")
        state = distribute(state, shd, mesh)
        step_fn = make_train_step(model, ocfg, microbatches=args.microbatches,
                                  grad_shardings=shd["params"])
        batch_shd = batch_shardings(model.input_specs(shape), mesh)

        history = []
        t0 = time.time()
        for step in range(start_step, args.steps):
            t_step = time.perf_counter()
            batch = distribute(synthetic_batch(model, cfg, shape, step, dev), batch_shd, mesh)
            state, metrics = step_fn(state, batch)
            loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])   # waits for the step
            history.append({"step": step + 1, "loss": loss, "grad_norm": gn,
                            "lr": float(metrics["lr"]),
                            "ms": (time.perf_counter() - t_step) * 1e3})
            if (step + 1) % args.log_every == 0 or step == start_step:
                dt = (time.time() - t0) / max(step - start_step + 1, 1)
                print(f"step {step + 1:5d}  loss {loss:.4f}  gnorm {gn:.3f}  "
                      f"{dt * 1e3:.0f} ms/step", flush=True)
                if not np.isfinite(loss):
                    raise FloatingPointError("loss diverged")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(state, args.ckpt_dir, step + 1)
        ckpt.wait()
    print(f"done: {args.steps - start_step} steps in {time.time() - t0:.1f}s")
    return history


if __name__ == "__main__":
    main()
