"""Serving launcher: ``python -m repro_torch.launch.serve [--engine sync|async]``.

Port of ``repro/launch/serve.py``.  Runs a reuse-aware serving fleet over a
real model (the reduced config, as the reference runs it): requests with
correlated input embeddings stream in, the ReuseRouter sends similar
requests to the same replica (rFIB semantics), and replicas answer from the
semantic cache when possible and run the model's prefill otherwise
(``make_executor``: the argmax of the last position's logits).  Prints the
reuse/latency summary, the serving analogue of the paper's Figure 8.

``--engine sync`` submits one request at a time through ``ServingFleet``;
``--engine async`` replays Poisson arrivals on the virtual clock through
``AsyncServingEngine`` with deadline batching.  With no execution-time
model the measured wall time of each miss group is its virtual duration,
as in the reference.  ``--engine cosim`` (with ``--offload-policy`` and
``--trace-out``) runs the network co-simulation, which comes with the
simulator slice: the parser accepts the flags and exits with an error.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..configs import get_arch
from ..core.lsh import LSHParams
from ..data import DATASETS, make_stream
from ..device import DeviceLike, resolve_device
from ..models import build_model
from ..serving import AsyncServingEngine, ReplicaEngine, ServeRequest, ServingFleet


def make_request(i: int, service: str, emb: np.ndarray, seq_len: int, vocab: int,
                 threshold: float = 0.9) -> ServeRequest:
    """A request whose payload is a token prompt derived from its embedding,
    ``(|emb[:seq_len]| * 1e4).astype(int64) % vocab``, as the reference's
    ``make_req`` derives it."""
    tokens = (np.abs(emb[:seq_len]) * 1e4).astype(np.int64) % vocab
    return ServeRequest(i, service, emb,
                        payload={"tokens": torch.from_numpy(tokens.astype(np.int32))[None, :]},
                        threshold=threshold)


def make_executor(model, seq_len: int) -> Callable[[List[ServeRequest]], List[int]]:
    """``execute(reqs) -> [argmax token of each request's last position]``.

    The reference prefills each request alone (batch 1) with ``max_len =
    seq_len + 8``.  A miss group's prompts all have ``seq_len`` tokens
    (``make_request``), so they run here as one (n, seq_len) prefill: each
    row's logits are the same function of its own tokens, so the tokens are
    the same."""
    max_len = seq_len + 8

    def execute(reqs: List[ServeRequest]) -> List[int]:
        if not reqs:
            return []
        tokens = torch.cat([r.payload["tokens"] for r in reqs]).to(model.device)
        logits, _ = model.prefill({"tokens": tokens}, max_len)
        return logits[:, -1].argmax(dim=-1).tolist()

    return execute


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> None:
    """``python -m repro_torch.launch.serve [--engine sync|async] [...]``.

    The reference's flags and defaults.  ``device`` (None: the CUDA card)
    carries the model, the replicas' stores and the router's hash."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--dataset", default="cctv1", choices=sorted(DATASETS))
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--engine", default="sync",
                    choices=("sync", "async", "cosim"),
                    help="sync: one submit per request; async: event-driven "
                         "engine with Poisson arrivals + deadline batching; "
                         "cosim: NDN network in front of engine-backed ENs "
                         "(comes with the simulator slice of the port)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="async/cosim offered load (requests/s, virtual clock)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--window-ms", type=float, default=8.0,
                    help="cosim EN-side batch window (milliseconds)")
    ap.add_argument("--offload-policy", default=None,
                    choices=("local-only", "least-loaded", "reuse-affinity"),
                    help="cosim federation policy (comes with the simulator "
                         "slice of the port)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="cosim only: Chrome trace-event / Perfetto JSON "
                         "(comes with the simulator slice of the port)")
    args = ap.parse_args(argv)
    for flag, given in (("--engine cosim", args.engine == "cosim"),
                        ("--offload-policy", args.offload_policy is not None),
                        ("--trace-out", args.trace_out is not None)):
        if given:
            ap.error(f"{flag} runs the network co-simulation, which comes with "
                     "the simulator slice of the port")

    dev = resolve_device(device)
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg, dev, seed=0)
    execute = make_executor(model, args.seq_len)
    lshp = LSHParams(dim=64, num_tables=5, num_probes=8)
    replicas = [ReplicaEngine(i, lshp, execute, device=dev)
                for i in range(args.replicas)]
    X, _ = make_stream(DATASETS[args.dataset], args.requests, seed=0)

    def make_req(i, emb):
        return make_request(i, args.dataset, emb, args.seq_len, cfg.vocab_size,
                            args.threshold)

    print(f"serving {cfg.name} (reduced: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) on {dev}")
    if args.engine == "async":
        engine = AsyncServingEngine(
            lshp, replicas, max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms * 1e-3, device=dev)
        rng = np.random.default_rng(0)
        arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
        futs = [engine.submit_at(t, make_req(i, emb))
                for i, (t, emb) in enumerate(zip(arrivals, X))]
        t_all = time.time()
        makespan = engine.drain()
        wall = time.time() - t_all
        lat = [(f.result.latency_s, f.result.reuse) for f in futs]
        stats = engine.stats()
        print(f"\n{len(futs)} requests drained in {wall:.1f}s wall "
              f"({makespan:.2f}s virtual, offered {args.rate:.0f} req/s, "
              f"window {args.max_wait_ms:.0f} ms x {args.max_batch})")
    else:
        fleet = ServingFleet(lshp, replicas, device=dev)
        lat = []
        t_all = time.time()
        for i, emb in enumerate(X):
            req = make_req(i, emb)
            t0 = time.perf_counter()
            res = fleet.submit(req)
            lat.append((time.perf_counter() - t0, res.reuse))
        wall = time.time() - t_all
        stats = fleet.stats()
        print(f"\n{len(lat)} requests in {wall:.1f}s over {args.replicas} replicas")
    by = lambda k: [l for l, r in lat if r == k]  # noqa: E731
    print(f"  reuse: cs={stats['cs']} en={stats['en']} "
          f"executed={stats['executed']} aggregated={stats['aggregated']}")
    if args.engine == "async":
        p99 = float(np.percentile([l for l, _ in lat], 99))
        print(f"  backups={stats['backups']} backup_wins={stats['backup_wins']} "
              f"dispatches={stats['dispatches']}  p99 latency {p99 * 1e3:.2f} ms")
    for kind in ("cs", "en", None):
        ls = by(kind)
        if ls:
            print(f"  latency[{kind or 'scratch':7s}] "
                  f"mean={np.mean(ls) * 1e3:7.2f} ms  n={len(ls)}")
    scratch, cs = by(None), by("cs")
    if scratch and cs:
        print(f"  speedup cs vs scratch: {np.mean(scratch) / np.mean(cs):.1f}x")


if __name__ == "__main__":
    main()
