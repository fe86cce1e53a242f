"""End-to-end training driver on the PyTorch/CUDA port: train a ~100M-param
qwen3-family model for a few hundred steps on a synthetic token stream with
the full stack — AdamW (bf16 moments), microbatching, async checkpointing,
restart.

Twin of ``examples/train_lm.py`` on ``repro_torch``, with the same flags,
config, schedule, synthetic batches, checkpoint points and printout.  It
runs on ``--device`` (default the CUDA card; without one it raises, so pass
``--device cpu``).  Its checkpoints go to ``--ckpt-dir``, by default
``repro_torch_train_lm`` under ``tempfile.gettempdir()`` (which honours
``$TMPDIR``): a directory of its own, since the reference's checkpoints
name their leaves otherwise.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.convert import load_params
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import build_model
from repro_torch.training import (
    AsyncCheckpointer,
    OptimizerConfig,
    init_state,
    latest_step,
    make_train_step,
    restore,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=512,
                    help="d_model (512 => ~100M params; shrink for slow CPUs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def lm_config(width: int):
    """~100M params at width 512: qwen3 family, 8 layers, vocab 50k."""
    w = width
    return dataclasses.replace(
        get_arch("qwen3-1.7b"), n_layers=8, d_model=w, n_heads=8,
        n_kv_heads=4, head_dim=w // 8, d_ff=4 * w, vocab_size=50_304,
        dtype="float32", loss_chunk=128)


def run(argv: Optional[Sequence[str]] = None, device: DeviceLike = None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Train as ``main`` does (``argv`` its flags; ``device`` overrides
    ``--device``).  Returns what it prints, as it prints it (``lines``,
    each also passed to ``log`` when it is due), and the numbers behind
    them: the step a checkpoint resumed (or None), the logged (step, loss,
    grad norm, lr), the steps taken, the first and last loss, and the final
    train state (``state``, as ``repro_torch.training.save`` takes it).
    ``params``: the initial weights by the port's parameter names (for
    instance the reference's init through ``repro_torch.convert``); default
    the port's seed 0.  A checkpoint in ``--ckpt-dir`` takes precedence."""
    lines = []

    def say(line: str) -> None:
        lines.append(line)
        if log is not None:
            log(line)

    args = parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    cfg = lm_config(args.width)
    model = build_model(cfg, dev, seed=0, trainable=True)
    if params is not None:
        load_params(model, params)
    out: Dict[str, Any] = {"lines": lines, "resumed": None, "logged": []}
    say(f"arch family qwen3, ~{cfg.flops_params() / 1e6:.0f}M params")

    shape = ShapeSpec("train", args.seq_len, args.batch, "train")
    ocfg = OptimizerConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps,
                           moment_dtype="bfloat16")
    step_fn = make_train_step(model, ocfg, microbatches=2)
    ckpt = AsyncCheckpointer()

    state = init_state(model, ocfg)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        restore(args.ckpt_dir, state)
        start = int(state["opt"]["step"])
        out["resumed"] = start
        say(f"resumed from checkpoint at step {start}")

    t0, first_loss = time.time(), None
    for step in range(start, args.steps):
        batch = synthetic_batch(model, cfg, shape, step % 64, dev)  # repeat data
        state, metrics = step_fn(state, batch)
        if step % 25 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            first_loss = first_loss or loss
            gn, lr = float(metrics["grad_norm"]), float(metrics["lr"])
            out["logged"].append((step, loss, gn, lr))
            say(f"step {step:4d}  loss {loss:.4f}  gnorm {gn:.2f}  lr {lr:.2e}")
        if step and step % 100 == 0:
            ckpt.save(state, args.ckpt_dir, step)
    ckpt.wait()
    final = float(metrics["loss"])
    out.update(steps=args.steps - start, first_loss=first_loss, final=final, state=state)
    say(f"\n{args.steps - start} steps in {time.time() - t0:.0f}s; "
        f"loss {first_loss:.3f} -> {final:.3f} "
        f"({'LEARNING' if final < first_loss else 'check config'})")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(argv, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
