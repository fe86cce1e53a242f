"""Serving launcher: ``python -m repro_torch.launch.serve [--engine sync|async|cosim]``.

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
as in the reference.

``--engine cosim`` runs the co-simulation instead (``build_cosim``): the NDN
testbed topology (``ReservoirNetwork``) forwards the same request stream to
two ENs whose execute path is an ``EngineBackend`` replica set running
*this model's* prefill (``make_service``) — forwarding, reuse-store search,
engine batching, and wall-measured model execution share one virtual
timeline.  ``--trace-out PATH`` writes its per-task trace (Chrome
trace-event JSON).  ``--offload-policy`` federates the two ENs
(``repro_torch.federation``): a miss may execute on, or be answered by, the
other EN.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..core.edge_node import Service
from ..core.lsh import LSHParams
from ..core.network import ReservoirNetwork
from ..core.topology import testbed_topology
from ..data import DATASETS, make_stream
from ..device import DeviceLike, resolve_device
from ..models import build_model
from ..serving import (
    AsyncServingEngine,
    EngineBackend,
    ReplicaEngine,
    ServeRequest,
    ServingFleet,
)

# the launcher's LSH: cross-polytope, 5 tables, 8 probes (as the reference's)
LSH_PARAMS = LSHParams(dim=64, num_tables=5, num_probes=8)


def make_request(i: int, service: str, emb: np.ndarray, seq_len: int, vocab: int,
                 threshold: float = 0.9) -> ServeRequest:
    """A request whose payload is a token prompt derived from its embedding,
    ``(|emb[:seq_len]| * 1e4).astype(int64) % vocab``, as the reference's
    ``make_req`` derives it."""
    tokens = (np.abs(emb[:seq_len]) * 1e4).astype(np.int64) % vocab
    return ServeRequest(i, service, emb,
                        payload={"tokens": torch.from_numpy(tokens.astype(np.int32))[None, :]},
                        threshold=threshold)


def rows_coupled(cfg) -> bool:
    """Whether a row's prefill depends on the other rows of its batch: an
    MoE layer's capacity and which tokens it drops depend on every token of
    the call."""
    return cfg.n_experts > 0


def make_executor(model, seq_len: int) -> Callable[[List[ServeRequest]], List[int]]:
    """``execute(reqs) -> [argmax token of each request's last position]``.

    The reference prefills each request alone (batch 1) with ``max_len =
    seq_len + 8``, with the payload as the batch (tokens only: a vision
    model runs without patches, and an encoder-decoder model fails for want
    of ``frames``, as the reference's does).  A miss group's prompts all
    have ``seq_len`` tokens (``make_request``); where rows are independent
    (dense, vision, hybrid, xLSTM) they run as one (n, seq_len) prefill,
    since each row's logits are the same function of its own tokens.  An
    MoE model (``rows_coupled``) prefills each request alone, as the
    reference does."""
    max_len = seq_len + 8

    def prefill(tokens: torch.Tensor) -> List[int]:
        logits, _ = model.prefill({"tokens": tokens.to(model.device)}, max_len)
        return logits[:, -1].argmax(dim=-1).tolist()

    def execute(reqs: List[ServeRequest]) -> List[int]:
        if not reqs:
            return []
        if rows_coupled(model.cfg):
            return [tok for r in reqs for tok in prefill(r.payload["tokens"])]
        return prefill(torch.cat([r.payload["tokens"] for r in reqs]))

    return execute


def make_service(model, dataset: str, seq_len: int) -> Service:
    """The edge service ``/<dataset>`` whose from-scratch path is ``model``'s
    prefill: ``execute(emb)`` is the argmax token of the last position of the
    prompt ``make_request`` derives from ``emb`` (the reference's
    ``svc_execute``).  It ends in a host read, so a wall-time measurement of
    it includes the device's work."""
    execute = make_executor(model, seq_len)
    vocab = model.cfg.vocab_size

    def run(emb: np.ndarray) -> int:
        emb = np.asarray(emb, np.float32)
        return execute([make_request(0, dataset, emb, seq_len, vocab)])[0]

    return Service(f"/{dataset}", execute=run, input_dim=64)


def build_cosim(model, X: np.ndarray, *, dataset: str = "cctv1",
                threshold: float = 0.9, rate: float = 200.0, replicas: int = 2,
                max_batch: int = 8, max_wait_s: float = 0.005,
                window_s: float = 0.008, seq_len: int = 32,
                trace: bool = False, profile: Optional[bool] = None,
                offload_policy: Optional[str] = None, device: DeviceLike = None,
                ) -> Tuple[ReservoirNetwork, EngineBackend]:
    """The co-simulation of ``--engine cosim``, ready to ``run()``.

    The testbed topology (two ENs, users ``u0`` at ``fwd1`` and ``u1`` at
    ``fwd2``), ``EngineBackend(wall_time=True)`` with ``replicas`` replicas
    an EN, an EN batch window of ``window_s``, and ``X`` submitted by the two
    users in turn at Poisson arrivals of ``rate`` on the virtual clock (seed
    0).  ``submit_task`` runs one untimed oracle prefill a task (the answer
    reuse accuracy is measured against), so every one of them has run when
    this returns.  ``trace`` arms the per-task tracer, ``profile`` the event
    loop's profiler (None: as ``RESERVOIR_PROFILE`` says).
    ``offload_policy`` (a name of ``federation.POLICY_NAMES``, None: no
    federator) lets an EN's miss run on the other EN.  ``device``
    (None: the card) carries the clients' hash, the EN stores and the
    replicas; ``model`` must live there too."""
    g, ens = testbed_topology()
    backend = EngineBackend(n_replicas=replicas, max_batch=max_batch,
                            max_wait_s=max_wait_s, wall_time=True)
    net = ReservoirNetwork(g, ens, LSH_PARAMS, seed=0, en_batch_window_s=window_s,
                           backend=backend, offload_policy=offload_policy,
                           trace=True if trace else None, profile=profile,
                           device=device)
    net.register_service(make_service(model, dataset, seq_len))
    net.add_user("u0", "fwd1")
    net.add_user("u1", "fwd2")
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, len(X)))
    for i, (t, emb) in enumerate(zip(arrivals, X)):
        net.submit_task(f"u{i % 2}", dataset, emb, threshold, at_time=float(t))
    return net, backend


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> None:
    """``python -m repro_torch.launch.serve [--engine sync|async|cosim] [...]``.

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
                         "cosim: NDN network in front of engine-backed ENs")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="async/cosim offered load (requests/s, virtual clock)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--window-ms", type=float, default=8.0,
                    help="cosim EN-side batch window (milliseconds)")
    ap.add_argument("--offload-policy", default=None,
                    choices=("local-only", "least-loaded", "reuse-affinity"),
                    help="cosim federation policy (reuse-aware offloading "
                         "between the co-simulated ENs)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="cosim only: arm per-task tracing and write the "
                         "Chrome trace-event / Perfetto JSON here")
    args = ap.parse_args(argv)
    if args.offload_policy is not None and args.engine != "cosim":
        ap.error("--offload-policy requires --engine cosim (federation "
                 "runs between the co-simulated ENs)")
    if args.trace_out is not None and args.engine != "cosim":
        ap.error("--trace-out requires --engine cosim (spans live on the "
                 "network's virtual timeline)")

    dev = resolve_device(device)
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg, dev, seed=0)
    execute = make_executor(model, args.seq_len)
    replicas = [ReplicaEngine(i, LSH_PARAMS, execute, device=dev)
                for i in range(args.replicas)]
    X, _ = make_stream(DATASETS[args.dataset], args.requests, seed=0)

    def make_req(i, emb):
        return make_request(i, args.dataset, emb, args.seq_len, cfg.vocab_size,
                            args.threshold)

    print(f"serving {cfg.name} (reduced: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) on {dev}")
    if args.engine == "cosim":
        net, backend = build_cosim(
            model, X, dataset=args.dataset, threshold=args.threshold,
            rate=args.rate, replicas=args.replicas, max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms * 1e-3, window_s=args.window_ms * 1e-3,
            seq_len=args.seq_len, trace=args.trace_out is not None,
            offload_policy=args.offload_policy, device=dev)
        # the oracle prefills ran in build_cosim; the timed region covers
        # only the co-simulation itself
        t_all = time.time()
        makespan = net.run()
        wall = time.time() - t_all
        # consumed by the engine-agnostic reuse/latency report further down
        lat = [(r.completion_time, r.reuse) for r in net.metrics.records
               if r.t_complete >= 0]
        stats = backend.stats()
        s = net.metrics.summary()
        if args.trace_out:
            net.loop.tracer.export(args.trace_out)
            print(f"trace: {len(net.loop.tracer.events)} events -> "
                  f"{args.trace_out}")
        if net.loop.profiler is not None:
            print(net.loop.profiler.report())
        print(f"\n{len(lat)} tasks through the co-sim in {wall:.1f}s wall "
              f"({makespan:.2f}s virtual, offered {args.rate:.0f} req/s, "
              f"EN window {args.window_ms:.0f} ms, {args.replicas} replicas/EN)")
        print(f"  network reuse: {s['reuse_pct']:.1f}% "
              f"(cs {s['reuse_pct_cs']:.1f}%, en {s['reuse_pct_en']:.1f}%), "
              f"accuracy {s['accuracy_pct']:.1f}%")
        ph = net.registry.phase_summary()
        print("  phases: " + "  ".join(
            f"{p}={ph[p + '_ms']:.2f}ms/n={ph[p + '_n']}"
            for p in ("forward", "search", "execute", "aggregate")))
        if net.federator is not None:
            fs = net.federator.stats
            print(f"  federation[{args.offload_policy}]: "
                  f"offloads={fs['offloads']} "
                  f"remote_hits={fs['remote_hits']} "
                  f"remote_execs={fs['remote_execs']} "
                  f"rebalances={fs['rebalances']}")
    elif args.engine == "async":
        engine = AsyncServingEngine(
            LSH_PARAMS, replicas, max_batch=args.max_batch,
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
        fleet = ServingFleet(LSH_PARAMS, replicas, device=dev)
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
