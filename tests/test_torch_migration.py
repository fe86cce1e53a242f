"""The port's store migration against the JAX package's, on the CPU.

* Mirrors of tests/test_migration.py (ownership-diff transfers on
  rebalance, EN leave and EN join, rerouting off a departed destination,
  stale-owner attribution, the rebalance face guard, rFIB membership
  invariants, ``owners_batch`` and ``AutoscalePolicy``): each scenario runs
  on both packages on the same seeded inputs; every task record, every
  counter and every EN store's live entries in LRU order (ids, rows,
  results, buckets) must be equal (``torch_mirror.same_net``), and the
  reference test's assertions hold on the port.
* A mirror of tests/test_store_properties.py ``TestMigrationParity``: a
  migrated range in the port's store answers as the reference's store
  built from the same entries.  The reference's fused path needs
  ``pl.load`` (gone from this JAX), so the port's fused path is held to the
  reference's staged path.
* The arms of benchmarks/migration.py rebuilt on both packages: at the
  ``--smoke`` size the reference side equals the benchmark's own run, and at
  full size the reference's figures are pinned (local hits 96.3 / 89.3 /
  92.8 %, 63 entries migrated).
* One migration arm with the port's stores on the card (marked ``cuda``)
  equals its CPU run task by task.
"""
import numpy as np
import pytest
import torch

from torch_mirror import (autoscale_arm, both, churn_arm, lib, same_fields, same_net, star,
                          store_state, svc)


def _make_net(L, n_ens=3, **kw):
    """tests/test_migration.py::_make_net on package ``L``."""
    g, ens = star(n_ens)
    net = L.ReservoirNetwork(g, ens, L.LSHParams(dim=16, num_tables=5, num_probes=8), seed=0,
                             **kw)
    net.register_service(svc(L, 0.05))
    net.add_user("u1", "core")
    return net


def _warm(L, net, n=120, seed=0, gap=0.06, thr=0.99):
    X = L.normalize(np.random.default_rng(seed).standard_normal((n, 16)).astype(np.float32))
    for i, x in enumerate(X):
        net.submit_task("u1", "svc", x, thr, at_time=i * gap)
    net.run()
    return X


def _sizes(net):
    return {n: len(net.edge_nodes[n].stores["svc"]) for n in net.en_nodes}


def _run(scenario):
    (port, *rest), (ref, *_) = both(scenario)
    same_net(port, ref)
    return (port, *rest)


def _owners_everywhere(net, L):
    """(node, [owner of each live entry]) for every live EN."""
    entries = net.forwarders["core"].rfib.entries("svc")
    out = []
    for node in net.en_nodes:
        ids, bks = net.edge_nodes[node].stores["svc"].live_buckets()
        out.append((node, L.owners_batch(entries, bks) if ids else []))
    return out


# --------------------------------------------------------------- migration
class TestStoreMigration:
    def test_rebalance_migrates_moved_ranges(self):
        def scenario(L):
            net = _make_net(L)
            _warm(L, net)
            before = _sizes(net)
            net.rebalance_service("svc", weights=[0.6, 0.3, 0.1])
            net.run()
            return net, before

        net, before = _run(scenario)
        after = _sizes(net)
        assert sum(after.values()) == sum(before.values())
        fs = net.federator.stats
        assert fs["migrated_entries"] > 0 and fs["migrated_in"] == fs["migrated_entries"]
        assert fs["migrate_acks"] == fs["migrate_batches"]
        out = sum(en.stats["migrated_out"] for en in net.edge_nodes.values())
        inn = sum(en.stats["migrated_in"] for en in net.edge_nodes.values())
        assert out == inn == fs["migrated_entries"] and after["en0"] > before["en0"]

    def test_migrated_entries_land_at_their_rfib_owner(self):
        def scenario(L):
            net = _make_net(L)
            _warm(L, net)
            net.rebalance_service("svc", weights=[0.5, 0.35, 0.15])
            net.run()
            return net, _owners_everywhere(net, L)

        net, owners = _run(scenario)
        for node, got in owners:
            assert all(o == net.edge_nodes[node].prefix for o in got), node

    def test_remove_en_hands_off_store_before_drain(self):
        def scenario(L):
            net = _make_net(L)
            _warm(L, net)
            total, n_victim = sum(_sizes(net).values()), len(net.edge_nodes["en2"].stores["svc"])
            net.remove_en("en2")
            net.run()
            return net, total, n_victim

        net, total, n_victim = _run(scenario)
        assert n_victim > 0 and len(net._departed["en2"].stores["svc"]) == 0
        assert sum(_sizes(net).values()) == total
        assert net.federator.stats["migrated_entries"] >= n_victim

    def test_add_en_join_pulls_its_ranges_warm(self):
        def scenario(L):
            net = _make_net(L)
            X = _warm(L, net)
            total = sum(_sizes(net).values())
            net.add_en("en3", attach_to="core")
            net.run()
            joined = dict(_sizes(net))
            owners = dict(_owners_everywhere(net, L))["en3"]
            rec = net.submit_task("u1", "svc", X[0], 0.9, at_time=net.loop.now + 0.1)
            net.run()
            return net, total, joined, owners, rec

        net, total, joined, owners, rec = _run(scenario)
        assert sum(joined.values()) == total and joined["en3"] > 0
        assert owners and all(o == "/en/en3" for o in owners)
        assert rec.t_complete >= 0

    def test_add_en_rejects_crashed_and_duplicate_ids(self):
        def scenario(L):
            net = _make_net(L)
            errors = []
            for node, kw, crash in (("en0", {"attach_to": "core"}, None),
                                    ("en2", {"attach_to": "core"}, "en2"),
                                    ("brand-new", {}, None)):
                if crash:
                    net.crash_en(crash)
                with pytest.raises(ValueError) as ei:
                    net.add_en(node, **kw)
                errors.append(str(ei.value))
            return net, errors

        _, errors = _run(scenario)
        assert "already an EN" in errors[0] and "crashed" in errors[1]
        assert "attach_to" in errors[2]

    def test_departed_rejoin_gets_fresh_state(self):
        def scenario(L):
            net = _make_net(L)
            _warm(L, net)
            net.remove_en("en2")
            net.run()
            net.add_en("en2", attach_to="core")
            net.run()
            return (net,)

        net, = _run(scenario)
        assert "en2" in net.en_nodes and _sizes(net)["en2"] > 0

    def test_reroute_when_destination_departs_mid_flight(self):
        def scenario(L):
            net = _make_net(L)
            _warm(L, net)
            total = sum(_sizes(net).values())
            fed = net._ensure_federator()
            ids = net.edge_nodes["en0"].stores["svc"].live_ids()[:5]
            assert len(ids) == 5
            fed.migrate_out("en0", "en1", "svc", ids)
            net.at(net.loop.now + 0.004, net.remove_en, "en1")
            net.run()
            return net, total

        net, total = _run(scenario)
        assert net.federator.stats["migrations_rerouted"] >= 1
        departed = len(net._departed["en1"].stores["svc"])
        assert sum(_sizes(net).values()) + departed == total and departed == 0

    def test_zero_churn_is_bit_identical_with_knob_off(self):
        def scenario(L):
            nets = []
            for knob in (True, False):
                net = _make_net(L, store_migration=knob)
                _warm(L, net, n=60, seed=3)
                assert net.federator is None
                nets.append(net)
            return tuple(nets)

        (port_on, port_off), (ref_on, ref_off) = both(scenario)
        same_net(port_on, ref_on)
        same_net(port_off, ref_off)
        same_net(port_on, port_off)

    def test_store_migration_off_strands_entries(self):
        def scenario(L):
            net = _make_net(L, store_migration=False)
            _warm(L, net)
            net.rebalance_service("svc", weights=[0.6, 0.3, 0.1])
            net.run()
            return net, _owners_everywhere(net, L)

        net, owners = _run(scenario)
        stranded = sum(o != net.edge_nodes[node].prefix for node, got in owners for o in got)
        assert stranded > 0 and net.federator is None


def _post_rebalance(L, migration):
    """tests/test_migration.py::TestStaleOwnerAttribution's traffic."""
    net = _make_net(L, offload_policy="reuse-affinity", store_migration=migration,
                    federation_kw={"rebalance": False})
    X = _warm(L, net)
    net.rebalance_service("svc", weights=[0.6, 0.3, 0.1])
    net.run()
    t0 = net.loop.now + 0.5
    rng = np.random.default_rng(42)
    recs = []
    for i, x in enumerate(X[:80]):
        near = L.normalize(x + 0.01 * rng.standard_normal(16).astype(np.float32))
        recs.append(net.submit_task("u1", "svc", near, 0.9, at_time=t0 + i * 0.06))
    net.run()
    return net, recs


class TestStaleOwnerAttribution:
    def test_stale_owner_hits_attributed_without_migration(self):
        net, recs = _run(lambda L: _post_rebalance(L, False))
        stale = [r for r in recs if r.stale_owner]
        assert stale and all(r.reuse == "en" and r.remote_en is not None for r in stale)
        fs = net.federator.stats
        assert fs["stale_owner_hits"] >= len(stale)
        assert sum(en.stats["stale_owner_hits"] for en in net.edge_nodes.values()) \
            == fs["stale_owner_hits"]
        assert net.metrics.stale_owner_fraction() > 0

    def test_local_hit_rate_recovers_with_migration(self):
        off, recs_off = _run(lambda L: _post_rebalance(L, False))
        on, recs_on = _run(lambda L: _post_rebalance(L, True))

        def local_en_hits(recs):
            return sum(1 for r in recs if r.reuse == "en" and r.remote_en is None)

        assert local_en_hits(recs_on) > local_en_hits(recs_off)
        assert sum(r.stale_owner for r in recs_on) < sum(r.stale_owner for r in recs_off)
        assert on.metrics.local_en_fraction() > off.metrics.local_en_fraction()


class TestRebalanceFaceGuard:
    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_missing_route_fails_loudly(self, pkg):
        net = _make_net(lib(pkg), n_ens=2)
        net.forwarders["core"].fib.remove("/en/en1")
        with pytest.raises(RuntimeError, match="no FIB route"):
            net.rebalance_service("svc")

    def test_app_face_zero_still_accepted(self):
        def scenario(L):
            net = _make_net(L, n_ens=2)
            hop = net.forwarders["en0"].fib.next_hop("/en/en0")
            net.rebalance_service("svc", weights=[0.7, 0.3])
            return net, hop

        net, hop = _run(scenario)
        faces = [e.faces for e in net.forwarders["en0"].rfib.entries("svc")
                 if e.en_prefix == "/en/en0"]
        assert hop == 0 and faces and all(f == [0] for f in faces)


class TestMembershipInvariants:
    def _names(self, net, prefix):
        return [(node, s) for node, fwd in net.forwarders.items() for s in net.services
                for e in fwd.rfib.entries(s) if e.en_prefix == prefix]

    def test_no_rfib_entry_names_departed_en(self):
        def scenario(L):
            net = _make_net(L)
            _warm(L, net, n=40)
            net.remove_en("en1")
            net.run()
            return (net,)

        net, = _run(scenario)
        assert not self._names(net, "/en/en1")

    def test_no_rfib_entry_names_dead_en_after_on_peer_dead(self):
        def scenario(L):
            net = _make_net(L)
            _warm(L, net, n=40)
            net.crash_en("en1")
            net.on_peer_dead("en1")
            return (net,)

        net, = _run(scenario)
        assert not self._names(net, "/en/en1")

    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_rfib_remove_en_is_gone(self, pkg):
        assert not hasattr(lib(pkg).RFIB, "remove_en")


class TestOwnersBatch:
    def test_owners_batch_matches_rfib_lookup(self):
        def scenario(L):
            net = _make_net(L)
            net.rebalance_service("svc", weights=[0.5, 0.3, 0.2])
            fwd = net.forwarders["core"]
            entries = fwd.rfib.entries("svc")
            X = L.normalize(np.random.default_rng(5).standard_normal((200, 16)).astype(np.float32))
            buckets = np.asarray(net.lsh.hash_batch(X), np.int64)
            batch = L.owners_batch(entries, buckets)
            majority, lookup = [], []
            for row in buckets:
                want = L.majority_owner(entries, row)
                majority.append(want.en_prefix if want is not None else None)
                name = L.make_task_name("svc", [int(b) for b in row],
                                        net.lsh_params.index_size_bytes)
                entry = fwd.rfib.lookup("/svc", L.parse_task_name(name)[2])
                lookup.append(entry.en_prefix if entry is not None else None)
            return net, batch, majority, lookup

        _, batch, majority, lookup = _run(scenario)
        assert batch == majority == lookup

    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_owners_batch_empty_cases(self, pkg):
        L = lib(pkg)
        assert L.owners_batch([], np.empty((0, 5), np.int64)) == []
        entries = _make_net(L, n_ens=2).forwarders["core"].rfib.entries("svc")
        assert L.owners_batch(entries, np.empty((0, 5), np.int64)) == []


class _Snap:
    def __init__(self, w):
        self.w = w

    def wait_s(self, now):
        return self.w


def _verdicts(kw, steps):
    """``AutoscalePolicy(**kw).desired`` over ``steps`` of (wait, n), on
    each package; the two must agree."""
    def scenario(L):
        p = L.AutoscalePolicy(**kw)
        return [p.desired(0, {f"en{i}": _Snap(w) for i in range(3)}, n) for w, n in steps]

    port, ref = both(scenario)
    assert port == ref
    return port


class TestAutoscalePolicy:
    def test_scale_up_needs_persistence(self):
        kw = dict(high_wait_s=0.1, low_wait_s=0.01, persistence=3, cooldown_rounds=2, min_ens=2,
                  max_ens=8)
        assert _verdicts(kw, [(0.5, 3)] * 3 + [(0.5, 4)] * 2) == [3, 3, 4, 4, 4]

    def test_scale_down_respects_min_and_cooldown(self):
        kw = dict(high_wait_s=0.1, low_wait_s=0.01, persistence=2, cooldown_rounds=1, min_ens=2,
                  max_ens=8)
        got = _verdicts(kw, [(0.0, 3), (0.0, 3), (0.0, 2), (0.0, 2), (0.0, 2), (9.0, 8)])
        assert got == [3, 2, 2, 2, 2, 8]

    def test_mid_band_resets_persistence(self):
        kw = dict(high_wait_s=0.1, low_wait_s=0.01, persistence=2, cooldown_rounds=0)
        assert _verdicts(kw, [(0.5, 3), (0.05, 3), (0.5, 3), (0.5, 3)]) == [3, 3, 3, 4]

    def test_autoscaler_drives_membership_via_federator(self):
        def scenario(L):
            net = _make_net(L, offload_policy="least-loaded",
                            federation_kw={"gossip_interval_s": 0.05, "rebalance": False})
            policy = L.AutoscalePolicy(high_wait_s=0.05, low_wait_s=1e-9, persistence=1,
                                       cooldown_rounds=3, min_ens=2, max_ens=4)
            counter = [0]

            def up():
                counter[0] += 1
                net.add_en(f"auto{counter[0]}", attach_to="core")

            net.federator.attach_autoscaler(policy, up, lambda: net.remove_en(net.en_nodes[-1]))
            _warm(L, net, n=80, gap=0.01)
            return (net,)

        net, = _run(scenario)
        assert net.federator.stats["scale_ups"] >= 1 and len(net.en_nodes) > 3
        assert all(r.t_complete >= 0 for r in net.metrics.records)


# ------------------------------ tests/test_store_properties.py migration
class TestMigrationParity:
    """A migrated bucket range answers, in the port's store, as the
    reference's store built from the same entries: the port's staged and
    fused paths against the reference's staged path."""

    def _fresh(self, L, **kw):
        p = L.LSHParams(dim=16, num_tables=3, num_probes=4, num_buckets=32, seed=11)
        if not L.port:
            kw.pop("fused", None)
        return L.ReuseStore(p, capacity=4096, bucket_cap=32, page_size=16, **kw)

    def _warm_src(self, L, n=300, **kw):
        src = self._fresh(L, **kw)
        X = L.normalize(np.random.default_rng(21).standard_normal((n, 16)).astype(np.float32))
        src.insert_batch(X, [f"r{i}" for i in range(n)])
        return src, X

    def _migrated(self, L, lo, hi, **kw):
        src, X = self._warm_src(L)
        exp = src.extract(src.ids_in_bucket_range(lo, hi))
        dst = self._fresh(L, **kw)
        dst.insert_batch(exp.embeddings, exp.results, buckets=exp.buckets)
        return src, dst, X, exp

    def test_migrated_range_answers_bit_identically(self):
        def scenario(L):
            src, dst, X, exp = self._migrated(L, 8, 23)
            return (store_state(src), store_state(dst), dst._slots.copy(), dst._fill.copy(),
                    [dst.query(q, 0.9) for q in X[:64]], len(exp))

        port, ref = both(scenario)
        assert port[5] > 20
        assert port[:2] == ref[:2]
        assert (port[2] == ref[2]).all() and (port[3] == ref[3]).all()
        assert port[4] == ref[4]

    def test_migrated_range_fused_path_parity(self):
        kw = dict(use_kernel_threshold=1, fused=True, fused_min_batch=1)

        def scenario(L):
            _, dst, X, _ = self._migrated(L, 0, 15, **kw)
            return store_state(dst), dst.query_batch(X, 0.9), getattr(dst, "fused_queries", 0)

        (pstate, got, fused), (rstate, want, _) = both(scenario)
        assert pstate == rstate and fused == len(want)
        assert [(r, i) for r, _, i in got] == [(r, i) for r, _, i in want]
        assert max(abs(a[1] - b[1]) for a, b in zip(got, want)) < 1e-5
        assert any(i is not None for _, _, i in got)

    def test_source_tombstones_survive_fused_requery(self):
        kw = dict(use_kernel_threshold=1, fused=True, fused_min_batch=1)

        def scenario(L):
            src, X = self._warm_src(L, **kw)
            src.query_batch(X[:4], 0.99)           # both mirrors resident first
            ids = src.ids_in_bucket_range(8, 23)
            exp = src.extract(ids)
            synced = src.sync_device()
            outs = src.query_batch(exp.embeddings, 0.999)
            rest = src.live_ids()[:8]
            again = src.query_batch(np.stack([src.embedding_of(i) for i in rest]), 0.999)
            return ids, exp.ids, synced, [o[2] for o in outs], rest, [o[2] for o in again]

        port, ref = both(scenario)
        ids, eids, synced, hits, rest, again = port
        assert synced >= 1
        assert all(i != e and (i is None or i not in set(ids)) for i, e in zip(hits, eids))
        assert again == rest
        assert (ids, eids, hits, rest, again) == (ref[0], ref[1], ref[3], ref[4], ref[5])

    def test_export_is_pure_read(self):
        def scenario(L):
            src, _ = self._warm_src(L)
            before = src.live_ids()
            exp = src.export(src.ids_in_bucket_range(0, 31))
            after = src.live_ids()
            row0 = exp.embeddings[0].copy()
            src.remove(exp.ids[0])
            return before, after, exp.ids, row0.tobytes(), exp.embeddings[0].tobytes()

        port, ref = both(scenario)
        assert port == ref
        before, after, ids, row0, still = port
        assert after == before and len(ids) > 0
        assert row0 == still         # a copy: the tombstone did not reach it

    def test_export_dead_slot_raises(self):
        for L in (lib("port"), lib("ref")):
            src, _ = self._warm_src(L, n=10)
            idx = src.live_ids()[0]
            src.remove(idx)
            with pytest.raises(KeyError):
                src.export([idx])
            with pytest.raises(KeyError):
                src.buckets_of(idx)


# ------------------------------------------------ benchmarks/migration.py
# the reference's current full-size run (equal to BENCH_migration.json)
CHURN_PINNED = {"baseline": (96.3, 0), "stranded": (89.3, 0), "migrate": (92.8, 63)}


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("mode", ["baseline", "stranded", "migrate"])
def test_churn_arm(mode, size):
    """The warm phase, the re-partition (migration off or on) and the
    measure phase: the port equals the reference record for record; at the
    smoke size the reference side equals the benchmark's ``_run_churn``, at
    full size its local-hit and migrated figures hold."""
    n_warm, n_meas, n_ens = (150, 150, 4) if size == "smoke" else (400, 600, 6)
    (port, got), (ref, want) = both(lambda L: churn_arm(L, mode, n_warm, n_meas, n_ens))
    same_net(port, ref)
    same_fields(got, want)
    if size == "smoke":
        from benchmarks import migration as bench

        same_fields(got, bench._run_churn(mode, n_warm, n_meas, n_ens))
    else:
        assert (round(got["local_hit_pct"], 1), got["migrated_entries"]) == CHURN_PINNED[mode]
        if mode != "baseline":
            assert round(got["moved_bucket_pct"], 1) == 76.6


@pytest.mark.parametrize("n_tasks", [200, 500])
def test_autoscale_arm(n_tasks):
    """The autoscaler grows the fleet under the burst and shrinks it in the
    trickle, migration keeping the state warm: the port equals the
    reference (at full size: one scale-up, two scale-downs, 66 entries
    migrated)."""
    (port, got), (ref, want) = both(lambda L: autoscale_arm(L, n_tasks))
    same_net(port, ref)
    same_fields(got, want)
    assert got["scale_ups"] >= 1 and got["scale_downs"] >= 1
    if n_tasks == 200:
        from benchmarks import migration as bench

        bench_out = bench._run_autoscale(n_tasks)
        assert {k: got[k] for k in bench_out} == bench_out
    else:
        assert (got["scale_ups"], got["scale_downs"], got["migrated_entries"]) == (1, 2, 66)


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_migrate_arm_on_the_card():
    """The migrate arm at its smoke size with the ENs' stores on the card
    (migration inserts with the shipped buckets, K3 on every EN query):
    every task record, counter and store equal to the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, got = churn_arm(lib("port", "cuda"), "migrate", 150, 150, 4)
    cpu, want = churn_arm(lib("port", "cpu"), "migrate", 150, 150, 4)
    same_net(card, cpu, sim_tol=1e-6)
    same_fields(got, want)
    assert got["migrated_entries"] > 0
