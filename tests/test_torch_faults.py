"""The port's fault layer against the JAX package's, on the CPU.

* Mirrors of tests/test_faults.py (the ``Future`` error path, ``FaultPlan``
  and ``ChaosController`` semantics, retransmission with backoff, PIT aging,
  NACKs, EN crash-stop with dead-peer detection, the offload timeout, slow
  nodes, gossip loss and jitter): each scenario runs on both packages on the
  same seeded inputs; every task record and every counter (the chaos
  controller's, the network's fault counters, the federator's) must be
  equal (``torch_mirror.same_net``), and the reference test's assertions
  hold on the port.
* The arms of benchmarks/fault_recovery.py rebuilt on both packages: at the
  ``--smoke`` size the reference side equals the benchmark's own run, and at
  full size (500 tasks at 40 Hz) loss 0/1/5 %, ``crash_en0`` and the
  zero-fault parity arm equal the reference's, with its current figures
  pinned (5 % loss: 100.0 % completion, 113 retransmissions).
* One lossy arm with the port's stores on the card (marked ``cuda``)
  equals its CPU run task by task.
"""
import math

import numpy as np
import pytest
import torch

from torch_mirror import (PLAN_SEED, both, fault_drive, fault_net, lib, loss_arm, crash_arm,
                          same_fields, same_net, star, svc)


def _make_net(L, n_ens=1, exec_time=0.02, protocol="direct", policy=None, fkw=None, plan=None,
              **net_kw):
    """tests/test_faults.py::_make_net on package ``L``: (net, chaos)."""
    g, ens = star(n_ens)
    net = L.ReservoirNetwork(g, ens, L.LSHParams(dim=16, num_tables=5, num_probes=8), seed=0,
                             protocol=protocol, offload_policy=policy, federation_kw=fkw,
                             **net_kw)
    chaos = L.ChaosController(net, plan) if plan is not None else None
    net.register_service(svc(L, exec_time))
    net.add_user("u1", "core")
    net.add_user("u2", "core")
    return net, chaos


def _run(scenario):
    """Run on both packages, hold the networks equal, return the port's."""
    (port, *rest), (ref, *_) = both(scenario)
    same_net(port, ref)
    return (port, *rest)


def _one_task(plan_fn=None, **kw):
    """One task of ``np.ones(16)`` from u1 at t=0 under ``plan_fn(L)``."""
    def scenario(L):
        net, chaos = _make_net(L, plan=plan_fn(L) if plan_fn else None, **kw)
        rec = net.submit_task("u1", "svc", np.ones(16), 0.9, at_time=0.0)
        net.run()
        return net, chaos, rec
    return _run(scenario)


def _drop_ready(net):
    def drop():
        for key in list(net._en_ready):
            entry = net._en_ready.pop(key)
            if entry.timer is not None:
                entry.timer.cancel()
    net.loop.at(0.04, drop)


# ------------------------------------------------------------ Future errors
def _outcomes(fn):
    port, ref = both(fn)
    assert port == ref
    return port


class TestFutureExceptions:
    def test_set_exception_rejects_and_result_raises(self):
        def scenario(L):
            f = L.Future()
            exc = L.ExecAborted("boom")
            f.set_exception(exc, now=1.5)
            with pytest.raises(L.ExecAborted):
                _ = f.result
            return f.done, f.exception is exc, f.resolved_at

        assert _outcomes(scenario) == (True, True, 1.5)

    def test_first_outcome_wins_across_kinds(self):
        def scenario(L):
            f, g = L.Future(), L.Future()
            a = f.try_set_exception(L.ExecAborted("x"))
            b = f.try_set_result(42)
            g.set_result(42)
            return a, b, g.try_set_exception(L.ExecAborted("late")), g.result

        assert _outcomes(scenario) == (True, False, False, 42)

    def test_done_callbacks_fire_on_exception(self):
        def scenario(L):
            f, seen = L.Future(), []
            f.add_done_callback(lambda fut: seen.append(fut.exception))
            f.set_exception(L.ExecAborted("y"))
            return len(seen), isinstance(seen[0], L.ExecAborted)

        assert _outcomes(scenario) == (1, True)

    def test_then_propagates_source_exception(self):
        def scenario(L):
            f = L.Future()
            out = f.then(lambda v: v + 1)
            f.set_exception(L.ExecAborted("z"), now=2.0)
            return out.done, isinstance(out.exception, L.ExecAborted), out.resolved_at

        assert _outcomes(scenario) == (True, True, 2.0)

    def test_then_captures_adapter_failure(self):
        def scenario(L):
            f = L.Future()
            out = f.then(lambda v: 1 / v)
            f.set_result(0)
            return out.done, type(out.exception)

        assert _outcomes(scenario) == (True, ZeroDivisionError)

    def test_propagate_forwards_value_and_error(self):
        def scenario(L):
            a, b, c, d = (L.Future() for _ in range(4))
            a.set_result(7, now=3.0)
            c.set_exception(L.ExecAborted("q"))
            return (a.propagate(b), b.result, b.resolved_at, c.propagate(d),
                    isinstance(d.exception, L.ExecAborted))

        assert _outcomes(scenario) == (True, 7, 3.0, True, True)


# ----------------------------------------------------------------- the plan
class TestFaultPlan:
    def test_empty_and_builders(self):
        def scenario(L):
            empty = L.FaultPlan().empty
            plan = L.FaultPlan.uniform_loss(0.05, jitter_s=0.001, seed=3)
            before = plan.empty, plan.links[0].loss, plan.links[0].jitter_s
            plan.with_crash("en0", 1.0).with_gossip_loss(0.2).with_slow_node("en1", 3.0)
            plan.with_partition({"a"}, 0.0, 1.0)
            return (empty, before, [(c.node, c.at) for c in plan.crashes], len(plan.gossip),
                    [(s.node, s.factor) for s in plan.slow_nodes],
                    [(p.group, p.t_start, p.t_end) for p in plan.partitions], plan.seed)

        got = _outcomes(scenario)
        assert got[0] and got[1] == (False, 0.05, 0.001) and got[2] == [("en0", 1.0)]
        port_plan = lib("port").FaultPlan().with_crash("en0", 1.0)
        assert port_plan.crashes == [lib("port").CrashEvent("en0", 1.0)]

    def test_link_fault_matching_is_symmetric_and_windowed(self):
        cases = [("u", "v", "data", 1.5), ("v", "u", "interest", 1.5), ("u", "w", "data", 1.5),
                 ("u", "v", "data", 2.0), ("u", "anything", "data", 0.0),
                 ("anything", "u", "data", 0.0), ("x", "y", "data", 0.0),
                 ("x", "y", "interest", 0.0)]

        def scenario(L):
            rules = [L.LinkFault(a="u", b="v", loss=1.0, t_start=1.0, t_end=2.0),
                     L.LinkFault(a="u", loss=1.0), L.LinkFault(kinds="interest", loss=1.0)]
            return [[r.matches(*c) for c in cases] for r in rules]

        window, pin, kind = _outcomes(scenario)
        assert window[:4] == [True, True, False, False]
        assert pin[4:7] == [True, True, False]
        assert kind[6:] == [False, True]

    def test_partition_separates_across_boundary_only(self):
        def scenario(L):
            p = L.Partition(frozenset({"a", "b"}), 0.0, 10.0)
            return [p.separates("a", "c", 5.0), p.separates("c", "b", 5.0),
                    p.separates("a", "b", 5.0), p.separates("c", "d", 5.0),
                    p.separates("a", "c", 10.0)]

        assert _outcomes(scenario) == [True, True, False, False, False]

    def test_same_plan_same_seed_same_fault_trace(self):
        def trace(seed):
            def scenario(L):
                net, chaos = _make_net(L, plan=L.FaultPlan.uniform_loss(0.3, seed=seed),
                                       retx_timeout_s=0.05)
                rng = np.random.default_rng(2)
                for i, x in enumerate(rng.standard_normal((40, 16))):
                    net.submit_task("u1", "svc", L.normalize(x.astype(np.float32)), 0.9,
                                    at_time=i * 0.01)
                net.run()
                return net, dict(chaos.stats), net.fault_stats["retx_sent"]
            return _run(scenario)[1:]

        assert trace(11) == trace(11)
        assert trace(11) != trace(12)


# -------------------------------------------------------- retransmission
class TestRetransmission:
    def test_interest_loss_recovered_by_retx(self):
        net, chaos, rec = _one_task(lambda L: L.FaultPlan(links=[L.LinkFault(
            a="user:u1", loss=1.0, kinds="interest", t_end=0.02)]), retx_timeout_s=0.05)
        assert chaos.stats["interest_drops"] == 1
        assert rec.t_complete >= 0.05 and rec.retx == 1 and not rec.failed
        assert net.fault_stats["retx_sent"] == 1 and net.metrics.completion_rate() == 1.0

    def test_data_loss_recovered_without_duplicate_execution(self):
        net, chaos, rec = _one_task(lambda L: L.FaultPlan(links=[L.LinkFault(
            loss=1.0, kinds="data", t_end=0.04)]), retx_timeout_s=0.08, exec_time=0.02)
        assert chaos.stats["data_drops"] >= 1
        assert rec.t_complete >= 0.08 and not rec.failed
        assert net.edge_nodes["en0"].stats["executed"] == 1
        assert net.metrics.completion_rate() == 1.0

    def test_spurious_retx_coalesces_on_inflight_execution(self):
        net, _, rec = _one_task(retx_timeout_s=0.05, exec_time=0.2)
        en = net.edge_nodes["en0"]
        assert en.stats["executed"] == 1 and en.stats["retx_coalesced"] >= 1
        assert rec.retx >= 1 and not rec.failed
        assert rec.t_complete == pytest.approx(0.2, abs=0.1)
        assert net.forwarders["core"].stats.retx_forwarded >= 1

    def test_backoff_doubles_each_retry(self):
        net, chaos, rec = _one_task(
            lambda L: L.FaultPlan(links=[L.LinkFault(loss=1.0, kinds="interest")]),
            retx_timeout_s=0.05, retx_backoff=2.0, retx_max=3)
        assert chaos.stats["interest_drops"] == 4
        assert rec.retx == 3 and rec.failed
        assert net.fault_stats["retx_give_ups"] == 1
        assert net.metrics.completion_rate() == 0.0 and net.loop.now >= 0.75

    def test_partitioned_user_gives_up(self):
        net, chaos, rec = _one_task(
            lambda L: L.FaultPlan(partitions=[L.Partition(frozenset({"user:u1"}))]),
            retx_timeout_s=0.02, retx_max=2)
        assert rec.failed and rec.t_complete < 0
        assert chaos.stats["partition_drops"] == 3
        assert net.metrics.completion_rate() == 0.0

    def test_retx_flag_distinct_from_independent_resubmission(self):
        def scenario(L):
            net, _ = _make_net(L, exec_time=0.1)
            net.submit_task("u1", "svc", np.ones(16), 0.9, at_time=0.0)
            net.submit_task("u1", "svc", np.ones(16), 0.9, at_time=0.01)
            net.run()
            fwd = net.users["u1"][1]
            return net, fwd.pit.aggregations, fwd.stats.retx_forwarded

        _, aggregations, retx_forwarded = _run(scenario)
        assert aggregations >= 1 and retx_forwarded == 0


# ----------------------------------------------------------------- PIT aging
class TestPitAging:
    def test_entries_expire_and_are_counted(self):
        net, _, _ = _one_task(lambda L: L.FaultPlan(links=[L.LinkFault(loss=1.0, kinds="data")]),
                              pit_lifetime_s=0.1, pit_sweep_interval_s=0.05)
        user_fwd = net.users["u1"][1]
        assert user_fwd.stats.pit_expired >= 1 and len(user_fwd.pit) == 0
        assert len(net.forwarders["core"].pit) == 0

    def test_default_lifetime_is_infinite(self):
        for L in (lib("port"), lib("ref")):
            net, _ = _make_net(L)
            assert net.pit_lifetime_s == math.inf
            assert net.forwarders["core"].pit.lifetime_s == math.inf


# --------------------------------------------------------------------- NACKs
class TestNacks:
    def test_unsolicited_fetch_gets_nack(self):
        def scenario(L):
            net, _ = _make_net(L, protocol="ttc")
            en = net.edge_nodes["en0"]
            net._en_fetch("en0", L.Interest(en.prefix + "/svc/task/00"))
            return (net,)

        net, = _run(scenario)
        assert net.edge_nodes["en0"].stats["fetch_drops"] == 1
        assert net.fault_stats["nacks_sent"] == 1

    def test_nack_without_retx_fails_the_task(self):
        def scenario(L):
            net, _ = _make_net(L, protocol="ttc", exec_time=0.05, en_ready_ttl_s=60.0)
            rec = net.submit_task("u1", "svc", np.ones(16), 0.9, at_time=0.0)
            _drop_ready(net)
            net.run()
            return net, rec

        net, rec = _run(scenario)
        assert net.fault_stats["nacks_sent"] >= 1 and net.fault_stats["nacks_received"] >= 1
        assert rec.failed and rec.t_complete < 0

    def test_nack_with_retx_reexpresses_and_completes(self):
        def scenario(L):
            net, _ = _make_net(L, protocol="ttc", exec_time=0.05, retx_timeout_s=0.05)
            rec = net.submit_task("u1", "svc", np.ones(16), 0.9, at_time=0.0)
            _drop_ready(net)
            net.run()
            return net, rec

        net, rec = _run(scenario)
        assert net.fault_stats["nacks_received"] >= 1
        assert not rec.failed and rec.t_complete >= 0 and rec.retx >= 1
        assert net.metrics.completion_rate() == 1.0


# ---------------------------------------------------------------- crash-stop
def _stream_run(L, net, n, seed, thr, spacing, alternate=True):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 16))
    for i, x in enumerate(X):
        user = ("u1" if i % 2 else "u2") if alternate else "u1"
        net.submit_task(user, "svc", L.normalize(x.astype(np.float32)), thr, at_time=i * spacing)
    net.run()


class TestCrashStop:
    def test_crash_drops_state_and_inflight_results(self):
        net, chaos, rec = _one_task(lambda L: L.FaultPlan().with_crash("en0", 0.01),
                                    exec_time=0.05)
        assert chaos.stats["crashes"] == 1 and net.fault_stats["crashed_ens"] == 1
        assert "en0" not in net.edge_nodes and "en0" in net._crashed
        assert net.fault_stats["crash_drops"] >= 1
        assert rec.t_complete < 0 and net.metrics.completion_rate() == 0.0

    def test_crash_is_not_a_graceful_leave(self):
        def scenario(L):
            net, _ = _make_net(L, n_ens=2)
            net.crash_en("en0")
            return (net,)

        net, = _run(scenario)
        dead = net._crashed["en0"].prefix
        assert any(e.en_prefix == dead for e in net.forwarders["core"].rfib.entries("/svc"))
        assert net.fault_stats["crash_recoveries"] == 0

    def test_detection_recovers_routing_and_tasks(self):
        def scenario(L):
            net, chaos = _make_net(L, n_ens=3, plan=L.FaultPlan().with_crash("en0", 0.10),
                                   exec_time=0.01, policy="local-only",
                                   fkw={"gossip_interval_s": 0.02}, retx_timeout_s=0.06,
                                   retx_max=6)
            X = L.normalize(np.random.default_rng(4).standard_normal((120, 16)).astype(np.float32))
            for i, x in enumerate(X):
                net.submit_task("u1" if i % 2 else "u2", "svc", x, 0.99, at_time=i * 0.005)
            net.run()
            return net, chaos

        net, chaos = _run(scenario)
        fed = net.federator
        assert chaos.stats["crashes"] == 1 and "en0" in fed.health.dead
        assert fed.stats["peers_dead"] == 1 and net.fault_stats["crash_recoveries"] == 1
        assert 0.10 < fed.health.dead["en0"] < 0.45
        dead = net._crashed["en0"].prefix
        assert not any(e.en_prefix == dead for e in net.forwarders["core"].rfib.entries("/svc"))
        assert net.metrics.completion_rate() == 1.0
        assert any(r.retx > 0 for r in net.metrics.records)
        assert net.fault_stats["crash_drops"] >= 1

    def test_hit_heavy_workload_still_detects_crash(self):
        def scenario(L):
            net, chaos = _make_net(L, n_ens=2, plan=L.FaultPlan().with_crash("en1", 0.50),
                                   exec_time=0.005, policy="local-only",
                                   fkw={"gossip_interval_s": 0.05}, retx_timeout_s=0.05,
                                   retx_max=6, cs_capacity=0, user_cs_capacity=0)
            rng = np.random.default_rng(6)
            base = L.normalize(rng.standard_normal((8, 16)).astype(np.float32))
            for i in range(120):
                x = base[i % 8] + 0.01 * rng.standard_normal(16).astype(np.float32)
                net.submit_task("u1" if i % 2 else "u2", "svc", L.normalize(x), 0.9,
                                at_time=i * 0.01)
            net.run()
            return net, chaos

        net, chaos = _run(scenario)
        done = [r for r in net.metrics.records if r.t_complete >= 0]
        assert chaos.stats["crashes"] == 1
        assert sum(r.reuse is not None for r in done) / len(done) > 0.5
        assert net.federator.stats["peers_dead"] == 1
        assert net.fault_stats["crash_recoveries"] == 1
        assert net.fault_stats["retx_give_ups"] == 0
        assert net.metrics.completion_rate() == 1.0

    def test_live_peers_are_never_suspected(self):
        def scenario(L):
            net, _ = _make_net(L, n_ens=3, exec_time=0.01, policy="local-only",
                               fkw={"gossip_interval_s": 0.02})
            _stream_run(L, net, 60, 5, 0.9, 0.01, alternate=False)
            return (net,)

        net, = _run(scenario)
        assert net.federator.health.suspects == set() and net.federator.health.dead == {}
        assert net.metrics.completion_rate() == 1.0


# ----------------------------------------------------------- offload timeout
def _direct_offload(L, timeout_s, crash):
    net, _ = _make_net(L, n_ens=2, exec_time=0.02, policy="local-only",
                       fkw={"offload_timeout_s": timeout_s})
    emb = L.normalize(np.ones(16, np.float32))
    name = L.make_task_name("svc", net.lsh.hash_one(emb), net.lsh_params.index_size_bytes)
    interest = L.Interest(name, app_params={"service": "svc", "input": emb, "threshold": 0.9})
    if crash:
        net.crash_en("en1")
    out = net.federator.offload("en0", "en1", "svc", interest, emb, 0.9, 0.0)
    net.run()
    return net, (out.done, out.exception, out.result.result, out.result.t_done), emb


class TestOffloadTimeout:
    def test_timed_out_offload_redispatches_locally(self):
        net, (done, exc, result, _), emb = _run(lambda L: _direct_offload(L, 0.05, True))
        fed = net.federator
        assert done and exc is None and result == pytest.approx(np.sum(emb), abs=1e-3)
        assert fed.stats["offload_timeouts"] == 1 and fed.stats["timeout_redispatched"] == 1
        assert fed.health.excluded("en1")
        assert net.edge_nodes["en0"].stats["executed"] == 1

    def test_slow_remote_reply_still_wins_if_first(self):
        net, (done, exc, _, _), _ = _run(lambda L: _direct_offload(L, 5.0, False))
        fed = net.federator
        assert done and exc is None and fed.stats["offload_timeouts"] == 0
        assert not fed.health.excluded("en1")
        assert net.edge_nodes["en1"].stats["executed"] == 1
        assert net.edge_nodes["en0"].stats["executed"] == 0


# ------------------------------------------------------- slow nodes + gossip
class TestSlowNodesAndGossip:
    def test_slow_node_inflates_execution(self):
        base, _, r0 = _one_task(exec_time=0.02)
        _, chaos, r1 = _one_task(lambda L: L.FaultPlan().with_slow_node("en0", factor=5.0),
                                 exec_time=0.02)
        assert chaos.stats["slow_samples"] == 1
        assert r1.t_complete - r0.t_complete == pytest.approx(0.08, abs=1e-3)

    def test_gossip_loss_starves_views_but_not_heartbeat(self):
        def scenario(L):
            net, chaos = _make_net(L, n_ens=3, exec_time=0.01,
                                   plan=L.FaultPlan().with_gossip_loss(1.0), policy="local-only",
                                   fkw={"gossip_interval_s": 0.02})
            _stream_run(L, net, 60, 6, 0.9, 0.01, alternate=False)
            return net, chaos

        net, chaos = _run(scenario)
        assert chaos.stats["gossip_drops"] > 0
        assert net.federator.gossip.gossip_dropped == chaos.stats["gossip_drops"]
        assert all(s.t == 0.0 for s in net.federator.gossip.views("en0").values())
        assert net.federator.health.dead == {} and net.metrics.completion_rate() == 1.0

    def test_jitter_delays_but_completes(self):
        _, chaos, rec = _one_task(lambda L: L.FaultPlan(links=[L.LinkFault(jitter_s=0.01)]),
                                  exec_time=0.02)
        net, _, base = _one_task(exec_time=0.02)
        assert chaos.stats["jitter_added"] > 0
        assert rec.t_complete > base.t_complete and net.metrics.completion_rate() == 1.0


# ------------------------------------------- benchmarks/fault_recovery.py
# the reference's current full-size run (equal to BENCH_fault_recovery.json)
LOSS_PINNED = {0.0: {"completion_pct": 100.0, "retx": 0, "drops": 0},
               0.01: {"completion_pct": 100.0, "retx": 28, "drops": 28},
               0.05: {"completion_pct": 100.0, "retx": 113, "drops": 113, "give_ups": 0}}


@pytest.mark.parametrize("rate,n_tasks", [(0.0, 150), (0.05, 150), (0.0, 500), (0.01, 500),
                                          (0.05, 500)])
def test_loss_arm(rate, n_tasks):
    """Uniform loss: the port equals the reference record for record; at
    the smoke size the reference side equals the benchmark's ``_run_loss``,
    at full size the reference's figures hold."""
    (port, got), (ref, want) = both(lambda L: loss_arm(L, rate, n_tasks))
    same_net(port, ref)
    same_fields(got, want)
    if n_tasks == 150:
        from benchmarks import fault_recovery as bench

        same_fields(got, bench._run_loss(rate, n_tasks))
    else:
        assert {k: got[k] for k in LOSS_PINNED[rate]} == LOSS_PINNED[rate]
    if rate:
        assert port.chaos.stats["interest_drops"] + port.chaos.stats["data_drops"] > 0


@pytest.mark.parametrize("n_tasks", [150, 500])
def test_crash_arm(n_tasks):
    """en0 crashes half-way: detection, re-partition and recovery equal the
    reference's (full size: detected 0.607 s after the crash, recovered in
    one 0.25 s window, 36 retransmissions)."""
    (port, got), (ref, want) = both(lambda L: crash_arm(L, n_tasks))
    same_net(port, ref)
    same_fields(got, want)
    assert got["peers_dead"] == 1 and got["recovered_routing"]
    assert got["completion_pct"] == 100.0
    if n_tasks == 150:
        from benchmarks import fault_recovery as bench

        same_fields(got, bench._run_crash(n_tasks))
    else:
        assert (round(got["time_to_detect_s"], 3), got["time_to_recover_s"], got["retx"],
                got["crash_drops"]) == (0.607, 0.25, 36, 36)


@pytest.mark.parametrize("n_tasks", [150, 200])
def test_zero_fault_parity_arm(n_tasks):
    """An empty plan with its seed is the plain run, on each package, and
    the two packages are the same run."""
    def scenario(L):
        plain, _ = fault_net(L, plan=None, retx=False)
        fault_drive(plain, n_tasks)
        chaotic, chaos = fault_net(L, plan=L.FaultPlan(seed=PLAN_SEED), retx=False)
        fault_drive(chaotic, n_tasks)
        return plain, chaotic, chaos

    (plain, chaotic, chaos), (jplain, jchaotic, _) = both(scenario)
    same_net(plain, jplain)
    same_net(chaotic, jchaotic)
    assert plain.metrics.summary() == chaotic.metrics.summary()
    assert sum(chaos.stats.values()) == 0


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_loss_arm_on_the_card():
    """The 5 % loss arm at its smoke size with the ENs' stores on the card:
    every task record and counter equal to the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, got = loss_arm(lib("port", "cuda"), 0.05, 150)
    cpu, want = loss_arm(lib("port", "cpu"), 0.05, 150)
    same_net(card, cpu, sim_tol=1e-6)
    same_fields(got, want)
    assert got["retx"] > 0
