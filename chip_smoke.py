#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc/`` (into
``build/kernels/``), holds each kernel against its plain PyTorch version on
the card, drives the port's serving path (two replicas behind a router,
100k-entry stores) and the store's fused-query acceptance configuration, and
checks the fused path against the staged one.  It prints one line per phase
with its seconds, the card's name and power limit, one JSON line
``{"kernels": [...]}`` with each kernel's launches on the serving path, error
against its plain version, time, plain time and bound, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.  Without a CUDA card it exits non-zero at once.  Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.lsh import LSHParams, normalize, sample_params  # noqa: E402
from repro_torch.core.reuse_store import ReuseStore  # noqa: E402
from repro_torch.kernels import build, lsh_hash, ops, ref, sim_topk  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    ReplicaEngine,
    ReuseRouter,
    ServeRequest,
)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# fp32 FLOP/s on the CUDA cores (the kernels use no tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SCORE_TOL = 1e-5    # kernel vs plain similarity (fp32, different sum order)
TIE_MARGIN = 1e-5   # ids may differ only where the float64 margin is below

SOURCES = {
    "reuse_top1": ("src/repro_torch/kernels/csrc/sim_topk.cu",
                   "src/repro/kernels/sim_topk.py:268"),
    "gather_top1": ("src/repro_torch/kernels/csrc/sim_topk.cu",
                    "src/repro/kernels/sim_topk.py:157"),
    "lsh_hash_mix": ("src/repro_torch/kernels/csrc/lsh_hash.cu",
                     "src/repro/kernels/lsh_hash.py:70"),
    "lsh_hash": ("src/repro_torch/kernels/csrc/lsh_hash.cu",
                 "src/repro/kernels/lsh_hash.py:97"),
}
MAIN_PATH = ("reuse_top1", "gather_top1", "lsh_hash_mix")

# sizes: phase 3 (kernels), phase 4 (serve), phase 5 (store)
HASH_B = 4096
K3_Q, K3_C = 32, 16384
K1_Q, K1_C = 1024, 20480
STORE_ROWS, PAGE_SIZE = 100_000, 4096
SERVE_CAPACITY, SERVE_BATCH, SMALL_BATCH, SERVE_BATCHES = 100_000, 1024, 32, 4
ACC_STORE, ACC_BATCH = 250_000, 4096
REPS, PLAIN_REPS = 20, 5


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def median_ms(fn, reps: int) -> float:
    """Median time of ``fn`` in ms from CUDA events, after a warm-up call."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(n_bytes: float, n_flop: float):
    """(least ms on an H100, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def top1_bound(q: np.ndarray, ids: np.ndarray):
    """Bound of a gather top-1 on this run's data: q, ids and each store row
    the ids reference read once, (score, id) written; 2·D FLOP for each
    distinct (query, id) pair (duplicates and -1 slots need none)."""
    d = q.shape[1]
    n_rows = np.unique(ids[ids >= 0]).size
    n_pairs = int(ops.unique_counts(ids).sum())
    return bound(q.nbytes + ids.nbytes + n_rows * d * 4 + q.shape[0] * 8,
                 2.0 * d * n_pairs)


# ------------------------------------------------------------------ phase 1
def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"matmul_precision={torch.get_float32_matmul_precision()}")
    expect(not torch.backends.cuda.matmul.allow_tf32
           and torch.get_float32_matmul_precision() == "highest",
           "TF32 is on for float32 matmuls: plain versions would not be fp32")
    return {"card": smi}


# ------------------------------------------------------------------ phase 3
def _unit(rng, *shape) -> np.ndarray:
    return normalize(rng.standard_normal(shape).astype(np.float32))


def _cp_margins(x: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """(B, T, K) float64 gap between the best and second-best vertex score."""
    proj = np.einsum("tkde,be->btkd", rot.astype(np.float64), x.astype(np.float64))
    s = np.sort(np.concatenate([proj, -proj], axis=-1), axis=-1)
    return s[..., -1] - s[..., -2]


def check_hash(name: str, got: torch.Tensor, want: torch.Tensor,
               margins: np.ndarray) -> tuple:
    """Equal ids, except where a vertex of that hash is a float64 near-tie;
    returns (max |id difference|, ids that differ)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    bad = g != w
    if g.ndim == 2:                        # mixed (B, T): any of its K rotations
        near = (margins < TIE_MARGIN).any(axis=-1)
    else:
        near = margins < TIE_MARGIN
    expect(not (bad & ~near).any(),
           f"{name}: {int((bad & ~near).sum())} ids differ away from a near-tie")
    return float(np.abs(g.astype(np.int64) - w).max()), int(bad.sum())


def check_top1(name: str, q: np.ndarray, rows: np.ndarray, got, want) -> tuple:
    """Kernel vs plain top-1: ids equal except at float64 near-ties, scores
    within SCORE_TOL.  rows: the flat (N, D) store on the host."""
    gv, gi = (t.cpu().numpy() for t in got)
    wv, wi = (t.cpu().numpy() for t in want)
    fin = np.isfinite(wv)
    expect((np.isfinite(gv) == fin).all(), f"{name}: found/not-found rows differ")
    expect(((gi < 0) == ~fin).all() and ((wi < 0) == ~fin).all(),
           f"{name}: -1 ids do not match -inf scores")
    err = float(np.abs(gv[fin] - wv[fin]).max()) if fin.any() else 0.0
    expect(err <= SCORE_TOL, f"{name}: max |score error| {err} > {SCORE_TOL}")
    ties = 0
    for r in np.flatnonzero(gi != wi):
        s = rows[[gi[r], wi[r]]].astype(np.float64) @ q[r].astype(np.float64)
        expect(abs(s[0] - s[1]) < TIE_MARGIN,
               f"{name}: row {r} picks {gi[r]} vs plain {wi[r]}, margin {s[0] - s[1]}")
        ties += 1
    return err, ties


def phase_kernels(dev: torch.device, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    # --- K4a / K4b at the serving hash shapes, then D=128, K=2 (the fold)
    for d, k in ((64, 1), (128, 2)):
        p = LSHParams(dim=d, num_tables=5, rotations_per_table=k, seed=seed)
        rot_np, _ = sample_params(p)
        x_np = _unit(rng, HASH_B, d)
        x, rot = torch.from_numpy(x_np).to(dev), torch.from_numpy(rot_np).to(dev)
        margins = _cp_margins(x_np, rot_np)
        nb = p.num_buckets
        for name, fn, plain in (
                ("lsh_hash_mix", lambda x=x, rot=rot: lsh_hash.lsh_hash_mix(x, rot, nb),
                 lambda x=x, rot=rot: ref.lsh_hash_mix_ref(x, rot, nb)),
                ("lsh_hash", lambda x=x, rot=rot: lsh_hash.lsh_hash(x, rot),
                 lambda x=x, rot=rot: ref.lsh_hash_ref(x, rot))):
            err, ties = check_hash(f"{name} D={d} K={k}", fn(), plain(), margins)
            ms, plain_ms = median_ms(fn, REPS), median_ms(plain, PLAIN_REPS)
            n_out = x_np.shape[0] * p.num_tables * (1 if name == "lsh_hash_mix" else k)
            bms, by = bound((x_np.size + rot_np.size + n_out) * 4,
                            2.0 * x_np.shape[0] * p.num_tables * k * d * d)
            log(f"  {name} B={x_np.shape[0]} D={d} T=5 K={k}: {ms:.4f} ms "
                f"(plain {plain_ms:.4f} ms, bound {bms:.5f} ms by {by}), "
                f"differing ids at near-ties {ties}")
            if d == 64:   # the serving path's shape is the one reported
                out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bms, "bound_by": by}

    # --- a paged (P, S, 64) store of store_rows rows, planted duplicates
    n, s_ = STORE_ROWS, PAGE_SIZE
    pages = -(-n // s_)
    rows = np.zeros((pages * s_, 64), np.float32)
    rows[:n] = _unit(rng, n, 64)
    dup_src = rng.choice(n // 2, 64, replace=False)
    dup_dst = n // 2 + dup_src
    rows[dup_dst] = rows[dup_src]           # equal rows: exact score ties
    store = torch.from_numpy(rows.reshape(pages, s_, 64)).to(dev)

    def near_queries(m: int, src: np.ndarray) -> np.ndarray:
        noise = 0.05 * rng.standard_normal((m, 64)).astype(np.float32) / 8.0
        return normalize(rows[src] + noise)

    # --- K3: sorted, unique, front-packed candidates (the staged batch)
    q3n, c3 = K3_Q, K3_C
    src = rng.integers(0, n, q3n)
    q3_np = near_queries(q3n, src)
    ids3 = np.full((q3n, c3), -1, np.int32)
    for r in range(q3n):
        cnt = int(rng.integers(c3 // 2, c3 + 1))
        pick = rng.choice(n, cnt, replace=False)
        pick[0] = src[r]
        ids3[r, :cnt] = np.sort(pick)
    q3, i3 = torch.from_numpy(q3_np).to(dev), torch.from_numpy(ids3).to(dev)
    fn = lambda: sim_topk.gather_top1(q3, store, i3)  # noqa: E731
    plain = lambda: ref.gather_top1_ref(q3, store, i3)  # noqa: E731
    err, ties = check_top1("gather_top1", q3_np, rows, fn(), plain())
    ms, plain_ms = median_ms(fn, REPS), median_ms(plain, PLAIN_REPS)
    bms, by = top1_bound(q3_np, ids3)
    log(f"  gather_top1 Q={q3n} C={c3} store {n}x64: {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, bound {bms:.5f} ms by {by}), max err {err:.3g}, "
        f"differing ids at near-ties {ties}")
    out["gather_top1"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": by}

    # --- K1: raw table candidates with duplicates, -1 slots and planted ties
    q1n, c1 = K1_Q, K1_C
    src = rng.integers(0, n, q1n)
    src[: q1n // 8] = dup_src[rng.integers(0, dup_src.size, q1n // 8)]
    q1_np = near_queries(q1n, src)
    q1_np[: q1n // 16] = rows[src[: q1n // 16]]     # exact: tie between src and dst
    ids1 = rng.integers(0, n, (q1n, c1)).astype(np.int32)
    ids1[rng.random((q1n, c1)) < 0.1] = -1          # empty slots
    dup_cols = rng.integers(0, c1, (q1n, c1 // 8))
    ids1[np.arange(q1n)[:, None], dup_cols] = ids1[:, : c1 // 8]   # duplicates
    col0 = rng.integers(0, c1, q1n)                  # the source and its twin
    col1 = (col0 + 1 + rng.integers(0, c1 - 1, q1n)) % c1
    ids1[np.arange(q1n), col0] = src
    partner = np.where(np.isin(src, dup_src), n // 2 + src, src)
    ids1[np.arange(q1n), col1] = partner
    q1, i1 = torch.from_numpy(q1_np).to(dev), torch.from_numpy(ids1).to(dev)
    fn = lambda: sim_topk.reuse_top1(q1, store, i1)  # noqa: E731
    plain = lambda: ref.reuse_top1_ref(q1, store, i1)  # noqa: E731
    got = fn()
    err, ties = check_top1("reuse_top1", q1_np, rows, got, plain())
    exact = np.arange(q1n // 16)
    expect((got[1].cpu().numpy()[exact] == np.minimum(src, partner)[exact]).all(),
           "reuse_top1: a planted exact tie did not go to the lowest id")
    ms, plain_ms = median_ms(fn, REPS), median_ms(plain, PLAIN_REPS)
    bms, by = top1_bound(q1_np, ids1)
    log(f"  reuse_top1 Q={q1n} C={c1} store {n}x64: {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, bound {bms:.5f} ms by {by}), max err {err:.3g}, "
        f"differing ids at near-ties {ties}")
    out["reuse_top1"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bms, "bound_by": by}
    return out


# ------------------------------------------------------------------ phase 4
def profile_call(name: str, fn, top: int = 8) -> None:
    """Where one call's time goes: device busy share (torch.profiler, one
    call) and the host functions with the most time (cProfile, another
    call; ``fn`` draws fresh inputs on each call)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies): an op's entry repeats them
    on_dev = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.key)
              for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(t for t, _ in on_dev)
    busy = (f"device busy {dev_ms:.3f} ms, idle share {1 - dev_ms / wall_ms:.3f}"
            if dev_ms > 0 else "device time not measured (the profiler saw none)")
    log(f"  profile {name}: wall {wall_ms:.3f} ms (under the profiler), {busy}; "
        "top device ops " + "; ".join(f"{k} {t:.3f} ms"
                                      for t, k in sorted(on_dev, reverse=True)[:4]))
    prof_host = cProfile.Profile()
    t0 = time.perf_counter()
    prof_host.enable()
    fn()
    sync()
    prof_host.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof_host).stats
    own = sorted(((tt, f"{Path(f).name}:{ln}:{fn_}") for (f, ln, fn_), (_, _, tt, _, _)
                  in stats.items()), reverse=True)[:top]
    # the port's own stages, by time including what they call
    stages = sorted(((ct, f"{Path(f).name}:{fn_}") for (f, ln, fn_), (_, _, _, ct, _)
                     in stats.items() if "repro_torch" in f), reverse=True)[:top]
    log(f"  host profile {name}: wall {wall_ms:.3f} ms (under cProfile); own time "
        + "; ".join(f"{k} {t * 1e3:.2f} ms" for t, k in own))
    log(f"  host stages {name}: " + "; ".join(f"{k} {t * 1e3:.2f} ms" for t, k in stages))


def _route_and_serve(router: ReuseRouter, replicas, reqs):
    """Route a batch (one hash launch), then one handle_batch per replica."""
    owners, _ = router.route_batch(np.stack([r.embedding for r in reqs]))
    results = [None] * len(reqs)
    for rid in sorted(set(owners.tolist())):
        idxs = np.flatnonzero(owners == rid)
        for i, res in zip(idxs, replicas[rid].handle_batch([reqs[i] for i in idxs])):
            results[i] = res
    return results


def compare_query(name: str, store: ReuseStore, q: np.ndarray, a, b) -> int:
    """Fused vs staged query_batch results: same ids (float64 near-ties
    excepted), similarities within SCORE_TOL."""
    ties = 0
    for i, ((ra, sa, ia), (rb, sb, ib)) in enumerate(zip(a, b)):
        expect(abs(sa - sb) <= SCORE_TOL or sa == sb, f"{name}: query {i} sim {sa} vs {sb}")
        if ia != ib:
            expect(ia is not None and ib is not None, f"{name}: query {i} hit vs miss")
            s = store._rows(np.array([ia, ib])).astype(np.float64) @ q[i].astype(np.float64)
            expect(abs(s[0] - s[1]) < TIE_MARGIN, f"{name}: query {i} id {ia} vs {ib}")
            ties += 1
        else:
            expect(ra == rb, f"{name}: query {i} result {ra!r} vs {rb!r}")
    return ties


def phase_serve(dev: torch.device, seed: int = 1) -> dict:
    """Two replicas behind a router (the serve.py configuration), stores
    filled to capacity through handle_batch, then mixed traffic."""
    rng = np.random.default_rng(seed)
    p = LSHParams(dim=64, num_tables=5, num_probes=8)
    execute = lambda reqs: [f"label-{r.request_id}" for r in reqs]  # noqa: E731
    cap, bsz = SERVE_CAPACITY, SERVE_BATCH
    replicas = [ReplicaEngine(i, p, execute, store_capacity=cap, device=dev)
                for i in range(2)]
    router = ReuseRouter(p, 2, device=dev)
    embs = []

    def requests(x: np.ndarray, thr: float = 0.9):
        base = sum(len(e) for e in embs)
        embs.append(x)
        return [ServeRequest(base + i, "svc", x[i], threshold=thr) for i in range(len(x))]

    def filled() -> int:
        return min(len(r.stores["svc"]) if "svc" in r.stores else 0 for r in replicas)

    ops.reset_launch_counts()
    t0, fill_batches = time.perf_counter(), 0
    while filled() < cap:
        expect(fill_batches < 4 * cap // bsz + 8, "stores never reached capacity")
        res = _route_and_serve(router, replicas, requests(_unit(rng, bsz, 64)))
        expect(all(r is not None for r in res), "a fill request got no result")
        fill_batches += 1
    sync()
    log(f"  fill: {fill_batches} batches of {bsz} -> stores "
        f"{[len(r.stores['svc']) for r in replicas]} in {time.perf_counter() - t0:.3f} s")

    n_sent = sum(len(e) for e in embs)
    all_x = np.concatenate(embs)

    def mixed(size: int):
        """Half near-duplicates of recent (still live) requests, half fresh."""
        src = rng.integers(n_sent - cap // 5, n_sent, size // 2)
        noise = 0.05 * rng.standard_normal((src.size, 64)).astype(np.float32) / 8.0
        return np.concatenate([normalize(all_x[src] + noise),
                               _unit(rng, size - src.size, 64)]), src

    kinds = {"cs": 0, "en": 0, None: 0}
    right = near_reused = near_total = fresh_exec = fresh_total = 0
    fused0 = [r.stores["svc"].fused_queries for r in replicas]
    staged0 = [r.stores["svc"].staged_queries for r in replicas]
    for size, n_batches in ((bsz, SERVE_BATCHES), (SMALL_BATCH, SERVE_BATCHES)):
        times = []
        for _ in range(n_batches):
            x, src = mixed(size)
            half = src.size
            t0 = time.perf_counter()
            res = _route_and_serve(router, replicas, requests(x))
            sync()
            times.append(time.perf_counter() - t0)
            for j, r in enumerate(res):
                kinds[r.reuse] += 1
                if j < half:
                    near_total += 1
                    if r.reuse is not None:
                        near_reused += 1
                        right += r.result == f"label-{src[j]}"
                else:
                    fresh_total += 1
                    fresh_exec += r.reuse is None
        log(f"  serve batches of {size}: {', '.join(f'{t * 1e3:.3f}' for t in times)} ms")
    counts = ops.launch_counts()   # the serving path's launches
    for size in (bsz, SMALL_BATCH):   # fresh traffic for every profiled call
        profile_call(f"serve batch of {size}", lambda size=size: _route_and_serve(
            router, replicas, requests(mixed(size)[0])))
    log(f"  hits by kind: cs {kinds['cs']}, en {kinds['en']}, executed {kinds[None]}; "
        f"near-duplicates reused {near_reused}/{near_total} ({right} with the source's "
        f"result), fresh executed {fresh_exec}/{fresh_total}; launches {counts}")
    expect(near_reused >= 0.8 * near_total, "too few near-duplicates were reused")
    expect(right >= 0.99 * near_reused, "reused near-duplicates got a wrong result")
    expect(fresh_exec >= 0.99 * fresh_total, "fresh requests were wrongly reused")
    expect(all(r.stores["svc"].fused_queries > f for r, f in zip(replicas, fused0)),
           "the large batches did not take the fused path")
    expect(all(r.stores["svc"].staged_queries > s for r, s in zip(replicas, staged0)),
           "the small batches did not take the staged path")

    # fused vs staged on the same store (peek: no state changes)
    store = replicas[0].stores["svc"]
    q = mixed(bsz)[0]
    fused = store.query_batch(q, 0.9, peek=True)
    expect(store.last_query_fused, "parity check: fused path not taken")
    store.fused = False
    staged = store.query_batch(q, 0.9, peek=True)
    store.fused = True
    ties = compare_query("serve fused vs staged", store, q, fused, staged)
    log(f"  fused vs staged on replica 0 ({len(store)} entries, {bsz} queries): "
        f"agree, differing ids at near-ties {ties}")
    return counts


# ------------------------------------------------------------------ phase 5
def phase_store(dev: torch.device, seed: int = 2) -> None:
    """The fused-query acceptance configuration (benchmarks/fused_query.py):
    hyperplane LSH, 16384 buckets, a 250k-entry store, query batch 4096."""
    rng = np.random.default_rng(seed)
    n, bsz = ACC_STORE, ACC_BATCH
    p = LSHParams(dim=64, num_tables=5, num_probes=8, num_buckets=16384,
                  family="hyperplane", seed=11)
    store = ReuseStore(p, capacity=n + 1, device=dev)
    x = _unit(rng, n, 64)
    t0 = time.perf_counter()
    for lo in range(0, n, 8192):
        store.insert_batch(x[lo:lo + 8192], list(range(lo, min(lo + 8192, n))))
    t_fill = time.perf_counter() - t0
    q = normalize(x[:bsz] + 0.05 * rng.standard_normal((bsz, 64)).astype(np.float32) / 8.0)
    store.query_batch(q, 0.9)           # first call: both mirrors go resident
    store.sync_device()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fused = store.query_batch(q, 0.9)
    sync()
    t_fused = time.perf_counter() - t0
    expect(store.last_query_fused, "store: fused path not taken")
    expect(store.last_sync_pages == 0 and store.last_table_sync_pages == 0,
           f"store: timed call uploaded {store.last_sync_pages} pages, "
           f"{store.last_table_sync_pages} table slabs")
    counts = ops.launch_counts()
    profile_call(f"fused query_batch({bsz})", lambda: store.query_batch(q, 0.9, peek=True))
    store.fused = False
    t0 = time.perf_counter()
    staged = store.query_batch(q, 0.9, peek=True)
    sync()
    t_staged = time.perf_counter() - t0
    ties = compare_query("store fused vs staged", store, q, fused, staged)
    hits = sum(r[2] is not None for r in fused)
    log(f"  store {len(store)} entries (filled in {t_fill:.3f} s), bucket_cap "
        f"{store.bucket_cap}: fused query_batch({bsz}) {t_fused * 1e3:.3f} ms, "
        f"staged {t_staged * 1e3:.3f} ms, hits {hits}/{bsz}, launches {counts}, "
        f"sync pages 0/0, differing ids at near-ties {ties}")


# ------------------------------------------------------------------ main
@contextlib.contextmanager
def timed(name: str):
    """Print a phase's start and, when it succeeds, its seconds."""
    t0 = time.perf_counter()
    log(f"phase {name} ...")
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with timed("env"):
        phase_env()
    with timed("build"):
        build.build_all()
    with timed("kernels"):
        kern = phase_kernels(dev)
    with timed("serve"):
        launches = phase_serve(dev)
    with timed("store"):
        phase_store(dev)
    for name in MAIN_PATH:
        expect(launches[name] > 0, f"{name} was not launched on the serving path")
    lines = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
              "replaces": SOURCES[name][1], "launches": launches[name],
              **kern[name], "library_ms": None} for name in SOURCES]
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
