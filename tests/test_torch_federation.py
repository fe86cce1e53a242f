"""The port's federation layer against the JAX package's, on the CPU.

* Mirrors of tests/test_federation.py (telemetry, the offload policies, the
  federated exchange and its coalescing, EN-leave failover, heterogeneous
  replica counts, load-driven rebalance): each scenario runs on both
  packages on the same seeded inputs; every task record, every counter and
  every store's live entries must be equal (``torch_mirror.same_net``), and
  the reference test's assertions hold on the port.
* The federation sweep of benchmarks/federation.py rebuilt on both packages
  (``torch_mirror.fed_arm``): at its ``--smoke`` size (4 ENs, 150 tasks at
  120 Hz) the reference side equals the benchmark's own run, and at full
  size (6 ENs, 600 tasks at 80 and 160 Hz, three policies and the rebalance
  row) the reference's current figures are pinned.
* One federated arm with the port's stores on the card (marked ``cuda``)
  equals its CPU run task by task.
"""
import numpy as np
import pytest
import torch

from torch_mirror import (FED_REBALANCE_KW, both, emb_routed_to, fed_arm, lib, same_fields,
                          same_net, star, svc)


def _make_net(L, n_ens=3, policy="local-only", backend=None, fkw=None, exec_time=(0.07, 0.1),
              window=0.0, protocol="direct"):
    """tests/test_federation.py::_make_net on package ``L``."""
    g, ens = star(n_ens)
    net = L.ReservoirNetwork(g, ens, L.LSHParams(dim=16, num_tables=5, num_probes=8), seed=0,
                             protocol=protocol, en_batch_window_s=window, backend=backend,
                             offload_policy=policy, federation_kw=fkw)
    net.register_service(svc(L, exec_time))
    net.add_user("u1", "core")
    net.add_user("u2", "core")
    return net


def _stream(L, n, seed, thr, spacing, net):
    X = L.normalize(np.random.default_rng(seed).standard_normal((n, 16)).astype(np.float32))
    for i, x in enumerate(X):
        net.submit_task("u1" if i % 2 else "u2", "svc", x, thr, at_time=i * spacing)


def _run(scenario):
    """Run on both packages, hold them equal, return the port's net."""
    (port, *rest), (ref, *_) = both(scenario)
    same_net(port, ref)
    return (port, *rest)


# ------------------------------------------------------------------ telemetry
class TestTelemetry:
    def test_inline_snapshot_reflects_busy_queue(self):
        for L in (lib("port"), lib("ref")):
            net = _make_net(L)
            node = net.en_nodes[0]
            snap0 = net.backend.load_snapshot(node, 0.0)
            assert snap0.depth == 0.0 and snap0.wait_s() == 0.0
            net._en_busy_until[node] = 1.7
            snap = net.backend.load_snapshot(node, 0.0)
            assert snap.wait_s() == pytest.approx(1.7, rel=0.2)
            assert snap.wait_s(now=0.5) == pytest.approx(snap.wait_s() - 0.5)
            assert snap.wait_s(now=100.0) == 0.0
        port, ref = (_make_net(L) for L in (lib("port"), lib("ref")))
        for net in (port, ref):
            net._en_busy_until["en1"] = 1.7
        assert vars(port.backend.load_snapshot("en1", 0.3)) == vars(
            ref.backend.load_snapshot("en1", 0.3))

    def test_engine_snapshot_counts_inflight_and_workers(self):
        def scenario(L):
            be = L.EngineBackend(n_replicas=3, seed=1)
            net = _make_net(L, backend=be)
            node = net.en_nodes[0]
            snap = be.load_snapshot(node, 0.0)
            assert snap.workers == 3 and snap.depth == 0.0
            be.engines[node].submit(L.ServeRequest(0, "svc", np.ones(16, np.float32),
                                                   payload=np.ones(16, np.float32)))
            depth = be.load_snapshot(node, 0.0).depth
            net.run()
            return net, depth, vars(snap)

        port, depth, snap = _run(scenario)
        assert depth == 1.0 and snap["workers"] == 3

    def test_gossip_rounds_and_staleness(self):
        def scenario(L):
            net = _make_net(L, fkw={"gossip_interval_s": 0.05})
            gossip = net.federator.gossip
            seeded = gossip.views(net.en_nodes[1])
            gossip.kick()
            net.at(1.0, lambda: None)
            net.run()
            return net, seeded, gossip.views(net.en_nodes[1]), gossip.staleness_s(net.en_nodes[1])

        port, seeded, views, stale = _run(scenario)
        assert set(seeded) == set(port.en_nodes) - {port.en_nodes[1]}
        assert all(s.t == 0.0 for s in seeded.values())
        assert all(s.t == pytest.approx(0.10) for s in views.values())
        assert stale == pytest.approx(0.90)
        assert not port.federator.gossip._timer.running

    def test_self_view_is_live_not_gossiped(self):
        for L in (lib("port"), lib("ref")):
            net = _make_net(L)
            net._en_busy_until[net.en_nodes[0]] = 9.0
            assert net.federator.gossip.self_view(net.en_nodes[0]).wait_s() > 0


# ------------------------------------------------------------------- offload
class TestOffload:
    def test_local_only_never_offloads(self):
        def scenario(L):
            net = _make_net(L, policy="local-only")
            X = L.normalize(np.random.default_rng(3).standard_normal((40, 16)).astype(np.float32))
            for i, x in enumerate(X):
                net.submit_task("u1" if i % 2 else "u2", "svc", x, 0.95, at_time=i * 0.004)
            net.run()
            return (net,)

        port, = _run(scenario)
        assert all(r.t_complete >= 0 for r in port.metrics.records)
        assert port.federator.stats["offloads"] == 0
        assert port.federator.stats["decisions"] > 0

    def test_least_loaded_offloads_and_executing_en_absorbs_insert(self):
        def scenario(L):
            net = _make_net(L, policy="least-loaded", n_ens=2)
            net._en_busy_until["en0"] = 5.0
            rec = net.submit_task("u1", "svc", emb_routed_to(net, L, "en0"), 0.9, at_time=0.0)
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.t_complete >= 0 and rec.reuse is None
        assert rec.reuse_node == "/en/en1" and rec.completion_time < 1.0
        fs = port.federator.stats
        assert fs["offloads"] == 1 and fs["remote_execs"] == 1
        assert len(port.edge_nodes["en1"].stores["svc"]) == 1
        assert len(port.edge_nodes["en0"].stores["svc"]) == 0
        assert port.edge_nodes["en0"].stats["offloaded"] == 1
        assert port.edge_nodes["en1"].stats["remote_execs"] == 1

    def test_reuse_affinity_peek_turns_miss_into_remote_hit(self):
        def scenario(L):
            net = _make_net(L, policy="reuse-affinity", n_ens=2)
            emb = emb_routed_to(net, L, "en0", seed=1)
            rng = np.random.default_rng(9)
            near = L.normalize(emb + 0.01 * rng.standard_normal(16).astype(np.float32))
            net.edge_nodes["en1"].stores["svc"].insert(near, round(float(np.sum(near)), 5))
            net._en_busy_until["en0"] = 5.0
            rec = net.submit_task("u1", "svc", emb, 0.9, at_time=0.0)
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.reuse == "en" and rec.reuse_node == "/en/en1"
        assert rec.similarity > 0.9 and rec.completion_time < 0.1
        fs = port.federator.stats
        assert fs["remote_hits"] == 1 and fs["remote_execs"] == 0

    def test_hysteresis_keeps_marginal_tasks_local(self):
        def scenario(L):
            net = _make_net(L, policy="least-loaded")
            rec = net.submit_task("u1", "svc", emb_routed_to(net, L, "en0", seed=2), 0.9,
                                  at_time=0.0)
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.t_complete >= 0 and port.federator.stats["offloads"] == 0

    def test_offload_with_engine_backend(self):
        def scenario(L):
            be = L.EngineBackend(n_replicas=1, max_batch=4, max_wait_s=0.002, seed=3)
            net = _make_net(L, policy="least-loaded", n_ens=2, backend=be,
                            fkw={"gossip_interval_s": 0.01})
            X = L.normalize(np.random.default_rng(5).standard_normal((60, 16)).astype(np.float32))
            for i, x in enumerate(X):
                net.submit_task("u1" if i % 2 else "u2", "svc", x, 0.95, at_time=i * 0.002)
            net.run()
            return net, be

        port, be = _run(scenario)
        assert all(r.t_complete >= 0 for r in port.metrics.records)
        assert port.federator.stats["offloads"] > 0
        executed = sum(en.stats["executed"] for en in port.edge_nodes.values())
        assert executed == be.stats()["executed"] >= 1

    def test_ttc_protocol_offload_completes(self):
        def scenario(L):
            net = _make_net(L, policy="least-loaded", n_ens=2, protocol="ttc")
            net._en_busy_until["en0"] = 3.0
            rec = net.submit_task("u1", "svc", emb_routed_to(net, L, "en0", seed=3), 0.9,
                                  at_time=0.0)
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.t_complete >= 0 and rec.completion_time < 1.0
        assert port.federator.stats["offloads"] == 1
        assert not port._en_ready


# ---------------------------------------------------- federated coalescing
def _shared_name(net, L):
    emb = L.normalize(np.ones(16, np.float32))
    return emb, L.make_task_name("svc", net.lsh.hash_one(emb), net.lsh_params.index_size_bytes)


class TestFederatedCoalescing:
    def test_two_ens_same_name_coalesce_at_executor(self):
        def scenario(L):
            net = _make_net(L, n_ens=3)
            fed = net._ensure_federator()
            emb, name = _shared_name(net, L)
            rng = np.random.default_rng(4)
            near = L.normalize(emb + 1e-3 * rng.standard_normal(16).astype(np.float32))
            assert name == L.make_task_name("svc", net.lsh.hash_one(near),
                                            net.lsh_params.index_size_bytes)
            futs = [fed.offload(src, "en2", "svc", L.Interest(name, app_params={
                "service": "svc", "input": e, "threshold": 0.9}), e, 0.9, 0.0)
                for src, e in (("en0", emb), ("en1", near))]
            net.run()
            return net, [(f.done, f.result.result, f.result.t_done) for f in futs]

        port, futs = _run(scenario)
        assert all(done for done, _, _ in futs) and futs[0][1] == futs[1][1]
        en = port.edge_nodes["en2"]
        assert en.stats["executed"] == 1 and en.stats["remote_execs"] == 1
        assert len(en.stores["svc"]) == 1

    def test_app_level_coalescing_with_engine_backend(self):
        def scenario(L):
            be = L.EngineBackend(n_replicas=1, max_batch=4, max_wait_s=0.002, seed=3)
            net = _make_net(L, n_ens=3, backend=be)
            fed = net._ensure_federator()
            emb, name = _shared_name(net, L)
            interest = L.Interest(name, app_params={"service": "svc", "input": emb,
                                                    "threshold": 0.9})
            fed.handle_remote("en2", interest)
            fed.handle_remote("en2", interest.copy())
            net.run()
            return net, be

        port, be = _run(scenario)
        en = port.edge_nodes["en2"]
        assert en.stats["remote_coalesced"] == 1 and en.stats["remote_execs"] == 1
        assert be.stats()["executed"] == 1


# ------------------------------------------------------------------ EN leave
def _testbed_net(L, window=0.0):
    g, ens = L.testbed_topology()
    net = L.ReservoirNetwork(g, ens, L.LSHParams(dim=16, num_tables=5, num_probes=8), seed=0,
                             en_batch_window_s=window)
    net.register_service(svc(L, 0.05))
    net.add_user("u1", "fwd1")
    return net


class TestENLeave:
    def test_inflight_task_fails_over_to_new_owner(self):
        def scenario(L):
            net = _testbed_net(L)
            rec = net.submit_task("u1", "svc", emb_routed_to(net, L, "en1", seed=4), 0.9,
                                  at_time=0.0)
            net.at(0.004, net.remove_en, "en1")
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.t_complete >= 0 and rec.reuse_node == "/en/en2"
        assert len(port.edge_nodes["en2"].stores["svc"]) == 1
        assert len(port._departed["en1"].stores["svc"]) == 0
        for fwd in port.forwarders.values():
            assert all(e.en_prefix == "/en/en2" for e in fwd.rfib.entries("svc"))

    def test_window_buffered_tasks_fail_over(self):
        def scenario(L):
            net = _testbed_net(L, window=0.05)
            rec = net.submit_task("u1", "svc", emb_routed_to(net, L, "en1", seed=5), 0.9,
                                  at_time=0.0)
            net.at(0.03, net.remove_en, "en1")
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.t_complete >= 0 and rec.reuse_node == "/en/en2"

    def test_inflight_offload_redispatches_on_leave(self):
        def scenario(L):
            net = _make_net(L, policy="least-loaded", n_ens=3, exec_time=0.3)
            emb = emb_routed_to(net, L, "en0", seed=6)
            net._en_busy_until["en0"] = 5.0
            net._en_busy_until["en2"] = 1.0
            rec = net.submit_task("u1", "svc", emb, 0.9, at_time=0.0)
            net.at(0.05, net.remove_en, "en1")
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.t_complete >= 0
        assert port.federator.stats["leave_redispatched"] >= 1

    def test_double_leave_chains_failover(self):
        def scenario(L):
            net = _make_net(L, n_ens=3, exec_time=0.05)
            rec = net.submit_task("u1", "svc", emb_routed_to(net, L, "en0", seed=11), 0.9,
                                  at_time=0.0)
            net.at(0.004, net.remove_en, "en0")
            net.at(0.015, net.remove_en, "en1")
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.t_complete >= 0 and rec.reuse_node == "/en/en2"
        assert len(port.edge_nodes["en2"].stores["svc"]) == 1

    def test_remove_last_but_one_en_keeps_serving(self):
        def scenario(L):
            net = _make_net(L, n_ens=2)
            net.remove_en("en0")
            emb = L.normalize(np.random.default_rng(8).standard_normal(16).astype(np.float32))
            rec = net.submit_task("u1", "svc", emb, 0.9, at_time=0.0)
            net.run()
            return net, rec

        port, rec = _run(scenario)
        assert rec.t_complete >= 0


# ------------------------------------------- heterogeneous replica counts
class TestHeterogeneousReplicas:
    def test_replicas_per_en_map(self):
        def scenario(L):
            be = L.EngineBackend(n_replicas=2, replicas_per_en={"en0": 1, "en2": 4}, seed=1)
            net = _make_net(L, n_ens=3, backend=be)
            sizes = [len(be.engines[n].replicas) for n in ("en0", "en1", "en2")]
            workers = be.load_snapshot("en2", 0.0).workers
            _stream(L, 30, 2, 0.9, 0.01, net)
            net.run()
            return net, sizes, workers

        port, sizes, workers = _run(scenario)
        assert sizes == [1, 2, 4] and workers == 4
        assert all(r.t_complete >= 0 for r in port.metrics.records)

    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_replicas_per_en_validation(self, pkg):
        L = lib(pkg)
        with pytest.raises(ValueError, match="unknown ENs"):
            _make_net(L, n_ens=2, backend=L.EngineBackend(replicas_per_en={"nope": 2}))
        with pytest.raises(ValueError, match=">= 1 replica"):
            _make_net(L, n_ens=2, backend=L.EngineBackend(replicas_per_en={"en0": 0}))


# ----------------------------------------------------------------- rebalance
_SKEW_KW = {"gossip_interval_s": 0.02, "rebalance_every_rounds": 5, "rebalance_min_tasks": 8,
            "rebalance_skew": 1.5, "rebalance_persistence": 2}


def _share(net, node, prefix):
    nb = net.lsh_params.effective_buckets
    return sum(e.ranges[0][1] - e.ranges[0][0] + 1 for e in net.forwarders[node].rfib.entries(
        "svc") if e.en_prefix == prefix) / nb


class TestLoadDrivenRebalance:
    def test_persistent_skew_shifts_bucket_ownership(self):
        def scenario(L):
            net = _make_net(L, policy="reuse-affinity", n_ens=3, fkw=_SKEW_KW)
            net.rebalance_service("svc", weights=[0.7, 0.2, 0.1])
            initial = _share(net, "core", "/en/en0")
            _stream(L, 160, 6, 0.99, 0.004, net)
            net.run()
            return net, initial

        port, initial = _run(scenario)
        assert initial == pytest.approx(0.7, abs=0.05)
        assert port.federator.stats["rebalances"] >= 1
        assert _share(port, "core", "/en/en0") < 0.6
        assert all(r.t_complete >= 0 for r in port.metrics.records)
        user_fwd = [n for n, f in port.forwarders.items() if f is port.users["u1"][1]][0]
        assert _share(port, "core", "/en/en0") == pytest.approx(
            _share(port, user_fwd, "/en/en0"))

    def test_engine_replica_ranges_follow_rebalance(self):
        def scenario(L):
            be = L.EngineBackend(n_replicas=2, seed=1)
            net = _make_net(L, n_ens=2, backend=be)
            before = be.engines["en0"].router.bucket_range
            net.rebalance_service("svc", weights=[0.75, 0.25])
            spans = [(be.engines[n].router.bucket_range, list(be.engines[n].router._bounds))
                     for n in ("en0", "en1")]
            return net, before, spans

        port, before, spans = _run(scenario)
        nb = port.lsh_params.effective_buckets
        assert before == (0, round(nb / 2))
        (r0, b0), (r1, _) = spans
        assert r0 == (0, round(0.75 * nb)) and r1 == (round(0.75 * nb), nb)
        assert b0[0] == r0[0] and b0[-1] == r0[1]

    def test_balanced_load_never_rebalances(self):
        def scenario(L):
            net = _make_net(L, policy="least-loaded", n_ens=2, fkw=_SKEW_KW)
            _stream(L, 120, 7, 0.99, 0.004, net)
            net.run()
            return (net,)

        port, = _run(scenario)
        assert port.federator.stats["rebalances"] == 0


# ------------------------------------------------- benchmarks/federation.py
POLICIES = ("local-only", "least-loaded", "reuse-affinity")
# the reference's current run at full size (not BENCH_federation.json's,
# which predates store migration): the acceptance figures of the port
FED_PINNED = {
    ("reuse-affinity", 80.0): {"reuse_pct": 92.2, "offloads": 133, "remote_hits": 121},
    ("least-loaded", 80.0): {"reuse_pct": 83.3, "offloads": 42, "remote_hits": 9},
    ("reuse-affinity", 160.0): {"reuse_pct": 91.3, "offloads": 147, "remote_hits": 124},
    ("rebalance", 160.0): {"reuse_pct": 91.3, "offloads": 143, "remote_hits": 121},
}


def _fed_row(policy, load, n_tasks, n_ens):
    fkw = FED_REBALANCE_KW if policy == "rebalance" else None
    pol = "reuse-affinity" if policy == "rebalance" else policy
    (port, got), (ref, want) = both(lambda L: fed_arm(L, pol, load, n_tasks, n_ens, fkw))
    same_net(port, ref)
    same_fields(got, want)
    return got


@pytest.mark.parametrize("policy", POLICIES + ("rebalance",))
def test_federation_smoke_arm(policy):
    """benchmarks/federation.py --smoke's arms: the port equals the
    reference record for record, and the reference side equals the
    benchmark's own ``_run_one``."""
    from benchmarks import federation as bench

    got = _fed_row(policy, 120.0, 150, 4)
    if policy == "rebalance":
        want = bench._run_one("reuse-affinity", 120.0, 150, 4, federation_kw=FED_REBALANCE_KW)
        assert got["rebalances"] >= 1
    else:
        want = bench._run_one(policy, 120.0, 150, 4)
    same_fields(got, want)
    if policy == "reuse-affinity":
        assert got["offloads"] > 0


@pytest.mark.parametrize("policy,load", [(p, load) for load in (80.0, 160.0) for p in POLICIES]
                         + [("rebalance", 160.0)])
def test_federation_full_arm(policy, load):
    """The full sweep (6 ENs, 600 tasks; the rebalance row at 160 Hz only):
    port equal to the reference, and the reference's current figures."""
    got = _fed_row(policy, load, 600, 6)
    pinned = FED_PINNED.get((policy, load), {})
    assert {k: round(got[k], 1) if k == "reuse_pct" else got[k] for k in pinned} == pinned
    if policy == "local-only":
        assert got["offloads"] == 0 and got["hot_share"] == pytest.approx(0.60, abs=0.005)


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_reuse_affinity_arm_on_the_card():
    """The reuse-affinity arm at its smoke size with the ENs' stores on the
    card (K3 for every EN query and peek, K4a for every hash): every task
    record and counter equal to the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, got = fed_arm(lib("port", "cuda"), "reuse-affinity", 120.0, 150, 4)
    cpu, want = fed_arm(lib("port", "cpu"), "reuse-affinity", 120.0, 150, 4)
    assert all(s.device.type == "cuda" for en in card.edge_nodes.values()
               for s in en.stores.values())
    same_net(card, cpu, sim_tol=1e-6)
    same_fields(got, want)
    assert got["remote_hits"] > 0
