"""Shared helpers of the port's federation, fault and migration mirrors
(tests/test_torch_{federation,faults,migration}.py).

``lib("port")`` and ``lib("ref")`` give the same names from the two
packages, so one scenario runs on both: the port's network and stores on
``device`` (the CPU unless a card test asks for it).  The JAX package is
imported on use only, so the card tests of those files collect on a machine
without JAX.  ``same_net`` holds two finished networks equal: every task
record, every counter (ENs, forwarders, federator, chaos, faults, engines),
the rFIB entries and every EN store's live entries in LRU order (ids, rows,
results, buckets).

The benchmark arms (``fed_arm``, ``churn_arm``, ``autoscale_arm``,
``loss_arm``, ``crash_arm``) rebuild benchmarks/federation.py,
benchmarks/migration.py and benchmarks/fault_recovery.py on either package
and return the network beside the fields the benchmark derives from it.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from types import SimpleNamespace

import networkx as nx
import numpy as np

from repro_torch.core.lsh import normalize as _normalize


def lib(pkg: str, device: str = "cpu") -> SimpleNamespace:
    """The classes and helpers a mirror needs, from the port (``"port"``,
    network and stores on ``device``) or the JAX package (``"ref"``)."""
    if pkg == "port":
        from repro_torch.core import rfib
        from repro_torch.core.edge_node import ExecAborted, Service
        from repro_torch.core.lsh import LSHParams, normalize
        from repro_torch.core.namespace import make_task_name, parse_task_name
        from repro_torch.core.network import ReservoirNetwork
        from repro_torch.core.packets import Interest
        from repro_torch.core.reuse_store import ReuseStore
        from repro_torch.core.sim_clock import Future
        from repro_torch.core.topology import testbed_topology
        from repro_torch.faults import (ChaosController, CrashEvent, FaultPlan,
                                        LinkFault, Partition)
        from repro_torch.federation.policy import AutoscalePolicy
        from repro_torch.serving import EngineBackend, ServeRequest
        net_cls = functools.partial(ReservoirNetwork, device=device)
        store_cls = functools.partial(ReuseStore, device=device)
    else:
        from repro.core import ReservoirNetwork, ReuseStore, rfib
        from repro.core.edge_node import ExecAborted, Service
        from repro.core.lsh import LSHParams, normalize
        from repro.core.namespace import make_task_name, parse_task_name
        from repro.core.packets import Interest
        from repro.core.sim_clock import Future
        from repro.core.topology import testbed_topology
        from repro.faults import (ChaosController, CrashEvent, FaultPlan,
                                  LinkFault, Partition)
        from repro.federation.policy import AutoscalePolicy
        from repro.serving import EngineBackend, ServeRequest
        # the reference's fused Pallas path needs ``pl.load``: its staged
        # path, the fused path's oracle
        net_cls = ReservoirNetwork
        store_cls = functools.partial(ReuseStore, fused=False)
    return SimpleNamespace(
        port=pkg == "port", ReservoirNetwork=net_cls, ReuseStore=store_cls,
        LSHParams=LSHParams, Service=Service, EngineBackend=EngineBackend,
        ServeRequest=ServeRequest, ExecAborted=ExecAborted, Future=Future,
        normalize=normalize, make_task_name=make_task_name,
        parse_task_name=parse_task_name, Interest=Interest,
        testbed_topology=testbed_topology, owners_batch=rfib.owners_batch,
        majority_owner=rfib.majority_owner, RFIB=rfib.RFIB,
        ChaosController=ChaosController, FaultPlan=FaultPlan, LinkFault=LinkFault,
        Partition=Partition, CrashEvent=CrashEvent, AutoscalePolicy=AutoscalePolicy)


def both(scenario):
    """``scenario(L)`` on the port and on the reference: (port, ref)."""
    return scenario(lib("port")), scenario(lib("ref"))


def star(n_ens: int, link: float = 0.005):
    """Hub and spokes: ``en0..`` one core link from ``core``."""
    g = nx.Graph()
    ens = [f"en{i}" for i in range(n_ens)]
    for en in ens:
        g.add_edge("core", en, delay=link)
    return g, ens


def svc(L, exec_time=(0.07, 0.1), dim: int = 16):
    return L.Service("/svc", execute=lambda x: round(float(np.sum(x)), 5),
                     exec_time_s=exec_time, input_dim=dim)


def emb_routed_to(net, L, en_node, seed=0, dim=16):
    """An embedding whose task the rFIB routes to ``en_node``."""
    rng = np.random.default_rng(seed)
    fwd = net.users["u1"][1]
    want = net.edge_nodes[en_node].prefix
    for _ in range(512):
        emb = L.normalize(rng.standard_normal(dim).astype(np.float32))
        name = L.make_task_name("svc", net.lsh.hash_one(emb), net.lsh_params.index_size_bytes)
        entry = fwd.rfib.lookup("/svc", L.parse_task_name(name)[2])
        if entry is not None and entry.en_prefix == want:
            return emb
    raise AssertionError(f"no embedding routed to {en_node}")


# ------------------------------------------------------------- comparison
def _plain(d):
    return {k: None if v != v else v for k, v in d.items()}


def store_state(store):
    """A store's live entries in LRU order: ids, rows, results, buckets."""
    exp = store.export(store.live_ids())
    return (exp.ids, np.asarray(exp.embeddings).tobytes(), exp.results,
            np.asarray(exp.buckets, np.int64).tolist())


def _ens(net):
    return {attr: {n: en for n, en in getattr(net, attr).items()}
            for attr in ("edge_nodes", "_departed", "_crashed")}


def same_net(port, ref, sim_tol: float = 0.0) -> None:
    """Two finished networks are the same run.  ``sim_tol``: similarities
    may differ by that much (a store on the card scores with K3's fp32 chain,
    one on the CPU with numpy); every other field must be equal."""
    assert len(port.metrics.records) == len(ref.metrics.records)
    for a, b in zip(port.metrics.records, ref.metrics.records):
        if sim_tol:
            assert abs(a.similarity - b.similarity) <= sim_tol, (a, b)
            a, b = (dataclasses.replace(r, similarity=0.0) for r in (a, b))
        assert dataclasses.astuple(a) == dataclasses.astuple(b), (a, b)
    assert _plain(port.metrics.summary()) == _plain(ref.metrics.summary())
    assert dict(port.fault_stats) == dict(ref.fault_stats)
    assert port.en_nodes == ref.en_nodes
    for attr, ens in _ens(ref).items():
        mine = _ens(port)[attr]
        assert list(mine) == list(ens), attr
        for node, en in ens.items():
            assert dict(mine[node].stats) == dict(en.stats), node
            assert list(mine[node].stores) == list(en.stores)
            for name, store in en.stores.items():
                assert store_state(mine[node].stores[name]) == store_state(store), (node, name)
    for node, fwd in ref.forwarders.items():
        assert vars(port.forwarders[node].stats) == vars(fwd.stats), node
        for s in ref.services:
            assert ([(e.en_prefix, e.ranges, e.faces) for e in port.forwarders[node].rfib.entries(s)]
                    == [(e.en_prefix, e.ranges, e.faces) for e in fwd.rfib.entries(s)])
    assert (port.federator is None) == (ref.federator is None)
    if ref.federator is not None:
        assert dict(port.federator.stats) == dict(ref.federator.stats)
        assert port.federator.gossip.rounds == ref.federator.gossip.rounds
        if ref.federator.health is not None:
            assert port.federator.health.dead == ref.federator.health.dead
            assert port.federator.health.suspects == ref.federator.health.suspects
    assert (port.chaos is None) == (ref.chaos is None)
    if ref.chaos is not None:
        assert dict(port.chaos.stats) == dict(ref.chaos.stats)
    if hasattr(ref.backend, "stats"):
        assert port.backend.stats() == ref.backend.stats()
    assert port.loop.now == ref.loop.now


# ------------------------------------------------------- benchmark arms
DIM = 64
CONTENT_SKEW, CONTENT_NOISE = 1.1, 0.02


def zipf_stream(n: int, seed: int, centers: int, center_seed=None) -> np.ndarray:
    """The benchmarks' cluster stream with Zipf-popular clusters (centers
    drawn from ``center_seed``'s generator when given, else from the same
    generator as the picks, as benchmarks/federation.py draws them)."""
    rng = np.random.default_rng(seed)
    crng = rng if center_seed is None else np.random.default_rng(center_seed)
    base = _normalize(crng.standard_normal((centers, DIM)).astype(np.float32))
    p = 1.0 / np.arange(1, centers + 1) ** CONTENT_SKEW
    p /= p.sum()
    picks = rng.choice(centers, n, p=p)
    return _normalize(base[picks] + CONTENT_NOISE * rng.standard_normal(
        (n, DIM)).astype(np.float32))


def _zipf_weights(n: int) -> list:
    w = 1.0 / np.arange(1, n + 1)
    return list(w / w.sum())


def _submit(net, X, arrivals, n_users: int) -> None:
    for i, (t, x) in enumerate(zip(arrivals, X)):
        net.submit_task(f"u{i % n_users}", "svc", x, 0.9, at_time=float(t))


def _params(L):
    return L.LSHParams(dim=DIM, num_tables=5, num_probes=8, seed=11)


def fed_arm(L, policy: str, load: float, n_tasks: int, n_ens: int, fkw=None):
    """benchmarks/federation.py::_run_one (4 users on the hub, Zipf-weighted
    initial partition, 600 or ``n_tasks`` tasks at ``load`` Hz, seed 0):
    (net, the fields it derives)."""
    params = _params(L)
    g, ens = star(n_ens)
    net = L.ReservoirNetwork(g, ens, params, seed=0, offload_policy=policy,
                             federation_kw=fkw if fkw is not None else {"rebalance": False})
    net.register_service(svc(L, dim=DIM))
    net.rebalance_service("svc", weights=_zipf_weights(n_ens))
    for u in range(4):
        net.add_user(f"u{u}", "core")
    arrivals = np.cumsum(np.random.default_rng(2).exponential(1.0 / load, n_tasks))
    _submit(net, zipf_stream(n_tasks, 7, 48), arrivals, 4)
    net.run()
    m = net.metrics
    done = m.completed()
    assert len(done) == n_tasks
    cts = np.asarray([r.completion_time for r in done])
    instant = [r.completion_time for r in done if r.reuse is not None and not r.aggregated]
    per_en = [net.edge_nodes[n].stats["executed"] + net.edge_nodes[n].stats["reused"]
              for n in ens]
    fs = net.federator.stats
    e0 = [e for e in net.forwarders["core"].rfib.entries("svc") if e.en_prefix == "/en/en0"]
    share0 = ((e0[0].ranges[0][1] - e0[0].ranges[0][0] + 1) / params.effective_buckets
              if e0 else 0.0)
    return net, {
        "p99_ms": float(np.percentile(cts, 99)) * 1e3, "mean_ms": float(cts.mean()) * 1e3,
        "reuse_pct": m.reuse_fraction() * 100,
        "gap": (m.mean_completion(kind=(None,)) / float(np.mean(instant))
                if instant else float("nan")),
        "hot_share": max(per_en) / max(sum(per_en), 1), "en0_bucket_share": share0,
        "offloads": fs["offloads"], "remote_hits": fs["remote_hits"],
        "remote_execs": fs["remote_execs"], "rebalances": fs["rebalances"],
        **net.registry.phase_summary(),
    }


# benchmarks/federation.py's rebalance row
FED_REBALANCE_KW = {"rebalance": True, "rebalance_every_rounds": 10, "rebalance_min_tasks": 10,
                    "rebalance_skew": 1.8, "rebalance_persistence": 2}


def _mig_net(L, n_ens: int, migration: bool, **kw):
    g, ens = star(n_ens)
    net = L.ReservoirNetwork(g, ens, _params(L), seed=0, store_migration=migration, **kw)
    net.register_service(svc(L, exec_time=(0.030, 0.045), dim=DIM))
    net.add_user("u0", "core")
    net.add_user("u1", "core")
    return net


def _mig_submit(net, X, t0: float, load: float, seed: int) -> None:
    ts = t0 + np.cumsum(np.random.default_rng(seed).exponential(1.0 / load, len(X)))
    _submit(net, X, ts, 2)


def _local_hits(records) -> dict:
    cts = np.asarray([r.completion_time for r in records])
    n = max(len(records), 1)
    return {
        "n": len(records),
        "local_hit_pct": 100.0 * sum(r.reuse is not None and r.remote_en is None
                                     for r in records) / n,
        "en_hit_pct": 100.0 * sum(r.reuse == "en" and r.remote_en is None for r in records) / n,
        "reuse_pct": 100.0 * sum(r.reuse is not None for r in records) / n,
        "p99_ms": float(np.percentile(cts, 99)) * 1e3, "mean_ms": float(cts.mean()) * 1e3,
    }


def _owner_cells(entries, num_tables: int, num_buckets: int) -> np.ndarray:
    prefixes = sorted({e.en_prefix for e in entries})
    idx = {p: i for i, p in enumerate(prefixes)}
    cells = np.full((num_tables, num_buckets), -1, np.int64)
    for e in reversed(entries):
        for t, (lo, hi) in e.ranges.items():
            cells[t, lo:hi + 1] = idx[e.en_prefix]
    return cells


def churn_arm(L, mode: str, n_warm: int, n_meas: int, n_ens: int):
    """benchmarks/migration.py::_run_churn: a Zipf-partitioned warm phase at
    50 Hz, for ``stranded``/``migrate`` a re-partition to uniform weights
    (migration off/on), then the measure phase: (net, the derived fields)."""
    net = _mig_net(L, n_ens, migration=(mode == "migrate"))
    net.rebalance_service("svc", weights=_zipf_weights(n_ens))
    _mig_submit(net, zipf_stream(n_warm, 7, 48, center_seed=42), 0.0, 50.0, 2)
    net.run()
    moved = 0.0
    p = net.lsh_params
    if mode != "baseline":
        before = _owner_cells(net.forwarders["core"].rfib.entries("svc"), p.num_tables,
                              p.effective_buckets)
        net.rebalance_service("svc")
        net.run()
        after = _owner_cells(net.forwarders["core"].rfib.entries("svc"), p.num_tables,
                             p.effective_buckets)
        moved = float(np.mean(before != after))
    _mig_submit(net, zipf_stream(n_meas, 9, 48, center_seed=42), net.loop.now + 0.5, 50.0, 4)
    net.run()
    done = [r for r in net.metrics.records if r.t_complete >= 0]
    assert len(done) == n_warm + n_meas
    out = _local_hits(done[n_warm:])
    fs = net.federator.stats if net.federator is not None else {}
    out.update(moved_bucket_pct=moved * 100.0,
               migrated_entries=fs.get("migrated_entries", 0),
               migrate_batches=fs.get("migrate_batches", 0))
    return net, out


def autoscale_arm(L, n_tasks: int, windows: int = 8):
    """benchmarks/migration.py::_run_autoscale: 3 ENs under least-loaded
    with store migration and ``AutoscalePolicy``, a burst at 140 Hz then a
    trickle at 12 Hz: (net, the derived fields)."""
    net = _mig_net(L, 3, migration=True, offload_policy="least-loaded",
                   federation_kw={"gossip_interval_s": 0.05, "rebalance": False})
    net.rebalance_service("svc")
    policy = L.AutoscalePolicy(high_wait_s=0.02, low_wait_s=0.004, persistence=2,
                               cooldown_rounds=8, min_ens=2, max_ens=6)
    events, counter = [], [0]

    def up():
        counter[0] += 1
        net.add_en(f"auto{counter[0]}", attach_to="core")
        events.append((round(net.loop.now, 3), "add", len(net.en_nodes)))

    def down():
        net.remove_en(net.en_nodes[-1])
        events.append((round(net.loop.now, 3), "remove", len(net.en_nodes)))

    net.federator.attach_autoscaler(policy, up, down)
    X = zipf_stream(n_tasks, 13, 48, center_seed=42)
    n_burst = int(n_tasks * 0.6)
    ts = np.cumsum(np.random.default_rng(5).exponential(1.0 / 140.0, n_burst))
    _submit(net, X[:n_burst], ts, 2)
    _mig_submit(net, X[n_burst:], float(ts[-1]) + 0.2, 12.0, 6)
    net.run()
    done = [r for r in net.metrics.records if r.t_complete >= 0]
    assert len(done) == n_tasks
    t_lo, t_hi = min(r.t_submit for r in done), max(r.t_submit for r in done)
    edges = np.linspace(t_lo, t_hi + 1e-9, windows + 1)
    traj = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        win = [r for r in done if lo <= r.t_submit < hi]
        if win:
            m = _local_hits(win)
            traj.append({"t": round(float(lo), 2), "n": m["n"],
                         "reuse_pct": round(m["reuse_pct"], 1), "p99_ms": round(m["p99_ms"], 1)})
    fs = net.federator.stats
    return net, {"scale_ups": fs["scale_ups"], "scale_downs": fs["scale_downs"],
                 "migrated_entries": fs["migrated_entries"], "events": events,
                 "trajectory": traj, "overall": _local_hits(done),
                 "final_ens": len(net.en_nodes)}


# benchmarks/fault_recovery.py: 3 ENs, 3 users, 40 Hz, retransmission knobs
PLAN_SEED = zlib.crc32(b"reservoir-fault-recovery")
RETX = {"retx_timeout_s": 0.05, "retx_backoff": 2.0, "retx_max": 6}


def fault_net(L, plan=None, protocol="ttc", policy=None, fkw=None, retx=True):
    """benchmarks/fault_recovery.py::_build: (net, chaos)."""
    g, ens = star(3)
    net = L.ReservoirNetwork(g, ens, _params(L), seed=0, protocol=protocol,
                             offload_policy=policy, federation_kw=fkw, **(RETX if retx else {}))
    chaos = L.ChaosController(net, plan) if plan is not None else None
    net.register_service(svc(L, dim=DIM))
    for u in range(3):
        net.add_user(f"u{u}", "core")
    return net, chaos


def fault_drive(net, n_tasks: int, load: float = 40.0) -> None:
    arrivals = np.cumsum(np.random.default_rng(2).exponential(1.0 / load, n_tasks))
    _submit(net, zipf_stream(n_tasks, 7, 40), arrivals, 3)
    net.run()


def loss_arm(L, rate: float, n_tasks: int):
    """benchmarks/fault_recovery.py::_run_loss: uniform loss at ``rate``
    (an empty plan at 0): (net, the derived fields)."""
    plan = (L.FaultPlan.uniform_loss(rate, seed=PLAN_SEED) if rate > 0
            else L.FaultPlan(seed=PLAN_SEED))
    net, chaos = fault_net(L, plan=plan)
    fault_drive(net, n_tasks)
    m = net.metrics
    cts = [r.completion_time for r in m.completed()] or [0.0]
    return net, {
        "completion_pct": m.completion_rate() * 100,
        "p99_ms": float(np.percentile(cts, 99)) * 1e3, "mean_ms": float(np.mean(cts)) * 1e3,
        "reuse_pct": m.reuse_fraction() * 100, "retx": net.fault_stats["retx_sent"],
        "give_ups": net.fault_stats["retx_give_ups"],
        "drops": chaos.stats["interest_drops"] + chaos.stats["data_drops"],
    }


def crash_arm(L, n_tasks: int, window_s: float = 0.25):
    """benchmarks/fault_recovery.py::_run_crash: en0 (the Zipf-hot owner)
    crashes half-way under local-only with 50 ms gossip: (net, the derived
    fields)."""
    duration = n_tasks / 40.0
    t_crash = round(duration * 0.5, 3)
    plan = L.FaultPlan(seed=PLAN_SEED).with_crash("en0", t_crash)
    net, _ = fault_net(L, plan=plan, policy="local-only", fkw={"gossip_interval_s": 0.05})
    net.rebalance_service("svc", weights=_zipf_weights(3))
    fault_drive(net, n_tasks)
    m = net.metrics
    detect_t = net.federator.health.dead.get("en0")
    edges = np.arange(0.0, duration + window_s, window_s)
    wins = []
    for lo, hi in zip(edges, edges[1:]):
        win = [r for r in m.records if lo <= r.t_submit < hi]
        done = [r for r in win if r.t_complete >= 0]
        wins.append((lo, float("nan") if len(win) < 3
                     else sum(r.reuse is not None for r in done) / len(win)))
    warmup = min(2.0, t_crash / 2)
    pre = [f for t, f in wins if t + window_s <= t_crash and t >= warmup and np.isfinite(f)]
    pre_level = float(np.mean(pre)) if pre else float("nan")
    post = [(t, f) for t, f in wins if t >= t_crash and np.isfinite(f)]
    recover_t = next((t for t, f in post if f >= pre_level - 0.05), None)
    return net, {
        "completion_pct": m.completion_rate() * 100, "t_crash": t_crash,
        "time_to_detect_s": detect_t - t_crash if detect_t is not None else float("nan"),
        "pre_reuse_pct": pre_level * 100,
        "dip_reuse_pct": min((f for _, f in post), default=float("nan")) * 100,
        "time_to_recover_s": recover_t - t_crash if recover_t is not None else float("nan"),
        "retx": net.fault_stats["retx_sent"], "crash_drops": net.fault_stats["crash_drops"],
        "recovered_routing": net.fault_stats["crash_recoveries"] == 1,
        "peers_dead": net.federator.stats["peers_dead"],
    }


def same_fields(got: dict, want: dict) -> None:
    """Derived fields equal, NaN equal to NaN."""
    assert _plain(got) == _plain(want)
