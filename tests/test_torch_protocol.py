"""The port's NDN protocol layer and edge node against the JAX package's.

Mirrors of tests/test_core_network.py (``TestPIT``, ``TestFIB``,
``TestRFIB``, ``TestForwarderPipeline``, ``TestTTCPath``),
tests/test_protocol.py (``TestTTCProtocol``, ``TestLargeInputPull``,
``TestOptOut``) and tests/test_reuse.py (``TestEdgeNode``, ``TestEndToEnd``),
on the port with ``device="cpu"``.  Each test drives both packages' objects
with the same operations and holds the discrete outputs equal: forward
actions (face, name, hint, content, meta, processing delay), PIT verdicts,
``owners_batch`` and ``partition`` ranges, TTC responses, and each task
record of a network run (the port's CPU store scores with numpy, as the
reference does, so completion times are equal too).
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
from repro.core import edge_node as jedge
from repro.core import rfib as jrfib
from repro.core import topology as jtopo
from repro.data import DATASETS as JDATASETS
from repro.data import dataset_service as jdataset_service
from repro_torch.core import edge_node, rfib, topology
from repro_torch.core.fib import FIB
from repro_torch.core.forwarder import Forwarder
from repro_torch.core.lsh import LSHParams, get_lsh, normalize
from repro_torch.core.namespace import make_exact_name, make_task_name
from repro_torch.core.network import ReservoirNetwork
from repro_torch.core.packets import Data, Interest
from repro_torch.core.pit import PendingInterestTable
from repro_torch.data import DATASETS, dataset_service, make_stream

CPU = {"device": "cpu"}


def _act(a):
    """A forward action as plain values (the packages' classes differ)."""
    p = a.packet
    return (a.face, type(p).__name__, p.name, getattr(p, "forwarding_hint", None),
            getattr(p, "hop_limit", None), getattr(p, "content", None),
            dict(getattr(p, "meta", {})), a.delay_s)


def _acts(actions):
    return [_act(a) for a in actions]


def _record(r):
    return (r.task_id, r.user, r.service, r.name, r.t_submit, r.t_complete, r.reuse,
            r.reuse_node, r.aggregated, r.similarity, r.correct, r.result,
            r.forwarding_error, r.retx, r.failed)


def _summary(net):
    """``Metrics.summary()`` with NaN (a kind no task took) as None, so that
    equal summaries compare equal."""
    return {k: None if v != v else v for k, v in net.metrics.summary().items()}


def _same_runs(port, ref):
    assert len(port.metrics.records) == len(ref.metrics.records)
    for a, b in zip(port.metrics.records, ref.metrics.records):
        assert _record(a) == _record(b)
    assert _summary(port) == _summary(ref)
    for node in ref.en_nodes:
        assert dict(port.edge_nodes[node].stats) == dict(ref.edge_nodes[node].stats)


class TestPIT:
    def test_aggregation(self):
        pit = PendingInterestTable()
        i1, i2 = Interest("/x"), Interest("/x")
        assert pit.insert(i1, in_face=1, now=0.0) is True
        assert pit.insert(i2, in_face=2, now=0.0) is False
        assert pit.aggregations == 1
        assert pit.satisfy("/x") == [1, 2]
        assert pit.satisfy("/x") is None

    def test_same_verdicts(self):
        """Admission verdicts (new, aggregate, duplicate, retransmit, stale)
        and satisfied faces over one operation sequence."""
        tables = (PendingInterestTable(lifetime_s=1.0), J.PendingInterestTable(lifetime_s=1.0))
        outs = ([], [])
        for side, (pit, Int) in enumerate(zip(tables, (Interest, J.Interest))):
            first = Int("/a")
            ops = [(first, 1, 0.0), (Int("/a"), 2, 0.1),
                   (Int("/a", nonce=first.nonce), 1, 0.2),
                   (Int("/a", retx=1), 3, 0.3), (Int("/b"), 4, 0.3),
                   (Int("/a"), 5, 2.0)]
            for interest, face, now in ops:
                outs[side].append(pit.admit(interest, face, now))
            outs[side].append((pit.satisfy("/a"), pit.expire(5.0), len(pit),
                               pit.aggregations))
        assert outs[0] == outs[1]
        assert "aggregate" in outs[0] and "duplicate" in outs[0]

    def test_expiry(self):
        for PIT, Int in ((PendingInterestTable, Interest),
                         (J.PendingInterestTable, J.Interest)):
            pit = PIT(lifetime_s=1.0)
            pit.insert(Int("/x"), 1, now=0.0)
            assert pit.insert(Int("/x"), 2, now=5.0) is True


class TestFIB:
    def test_longest_prefix(self):
        got = []
        for F in (FIB, J.FIB):
            fib = F()
            fib.insert("/a", 1)
            fib.insert("/a/b", 2)
            fib.insert("/a/b", 7, cost=3)
            row = [fib.next_hop(n) for n in ("/a/b/c", "/a/x", "/z")]
            fib.insert("/", 9)
            row += [fib.next_hop("/z"), fib.lookup("/a/b/q"), len(fib)]
            fib.remove("/a/b", 2)
            row += [fib.next_hop("/a/b/c")]
            got.append(row)
        assert got[0] == got[1]
        assert got[0][:4] == [2, 1, None, 9]


class TestRFIB:
    def _rfib(self, mod=rfib):
        table = mod.RFIB()
        for e in mod.partition("/OpenPose", ["/EN1", "/EN2"], {"/EN1": [1], "/EN2": [2]},
                               num_tables=3, num_buckets=256):
            table.insert(e)
        return table

    def test_majority_vote_matches_paper_example(self):
        """Fig. 4: hash 6E810F -> buckets 110,129,15 -> majority EN1."""
        entry = self._rfib().lookup("/OpenPose", "6E810F")
        assert entry is not None and entry.en_prefix == "/EN1" and entry.faces == [1]
        assert self._rfib(jrfib).lookup("/OpenPose", "6E810F").en_prefix == "/EN1"

    def test_all_tables_agree_and_unknown_service(self):
        from repro_torch.core.namespace import encode_task_hash

        h = encode_task_hash([200, 210, 250], 1)
        assert self._rfib().lookup("/OpenPose", h).en_prefix == "/EN2"
        assert self._rfib().lookup("/Unknown", "00") is None
        assert self._rfib().size_bytes() == self._rfib(jrfib).size_bytes() > 0

    @pytest.mark.parametrize("n_ens,weights", [(7, None), (3, [1.0, 2.5, 0.5]),
                                               (4, [1.0, 0.0001, 1.0, 3.0])])
    def test_partition_ranges_equal(self, n_ens, weights):
        ens = [f"/EN{i}" for i in range(n_ens)]
        faces = {p: [i + 1] for i, p in enumerate(ens)}
        got = rfib.partition("/s", ens, faces, 3, 256, 1, weights=weights)
        want = jrfib.partition("/s", ens, faces, 3, 256, 1, weights=weights)
        assert ([(e.service, e.ranges, e.en_prefix, e.faces) for e in got]
                == [(e.service, e.ranges, e.en_prefix, e.faces) for e in want])
        covered = sorted(r[0] for e in got for r in [e.ranges[0]])
        assert covered[0] == 0

    def test_consecutive_ranges_cover_everything(self):
        entries = rfib.partition("/s", [f"/EN{i}" for i in range(7)], {}, 2, 256)
        covered = sorted((lo, hi) for e in entries for t, (lo, hi) in e.ranges.items()
                         if t == 0)
        assert covered[0][0] == 0 and covered[-1][1] == 255
        for (l1, h1), (l2, h2) in zip(covered, covered[1:]):
            assert l2 == h1 + 1

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_owners_batch_and_majority_owner_equal(self, seed):
        rng = np.random.default_rng(seed)
        ens = [f"/EN{i}" for i in range(int(rng.integers(2, 6)))]
        w = list(rng.uniform(0.2, 3.0, len(ens)))
        entries = rfib.partition("/s", ens, {}, 5, 256, 1, weights=w)
        jentries = jrfib.partition("/s", ens, {}, 5, 256, 1, weights=w)
        buckets = rng.integers(0, 256, (300, 5))
        got = rfib.owners_batch(entries, buckets)
        assert got == jrfib.owners_batch(jentries, buckets)
        assert got == [rfib.majority_owner(entries, b).en_prefix for b in buckets]
        assert rfib.owners_batch(entries, np.zeros((0, 5))) == []

    def test_rebalance_equal(self):
        tables = (self._rfib(), self._rfib(jrfib))
        for mod, table in zip((rfib, jrfib), tables):
            mod.rebalance(table, "/OpenPose", ["/EN1", "/EN2", "/EN3"],
                          {"/EN1": [1], "/EN2": [2], "/EN3": [3]}, 3, 256,
                          weights=[2.0, 1.0, 1.0])
        assert ([(e.ranges, e.en_prefix, e.faces) for e in tables[0].entries("OpenPose")]
                == [(e.ranges, e.en_prefix, e.faces) for e in tables[1].entries("OpenPose")])


class TestForwarderPipeline:
    def _forwarders(self):
        out = []
        for mod, F in ((rfib, Forwarder), (jrfib, J.Forwarder)):
            fwd = F("/fwd", cs_capacity=8, seed=3)
            fwd.fib.insert("/EN1", 5)
            fwd.fib.insert("/EN2", 6)
            for e in mod.partition("/svc", ["/EN1", "/EN2"], {"/EN1": [5], "/EN2": [6]},
                                   num_tables=1, num_buckets=256):
                fwd.rfib.insert(e)
            out.append(fwd)
        return out

    def _both(self, fn):
        """Run ``fn(fwd, Interest, Data)`` on the port's and the reference's
        forwarder; the actions and the stats must be equal."""
        (p, r) = self._forwarders()
        got = fn(p, Interest, Data)
        want = fn(r, J.Interest, J.Data)
        assert got == want
        assert dataclasses.asdict(p.stats) == dataclasses.asdict(r.stats)
        return got, p.stats

    def test_task_gets_forwarding_hint_via_rfib(self):
        (acts,), st = self._both(lambda f, I, D: [_acts(f.on_interest(
            I(make_task_name("/svc", [10], 1), nonce=1), in_face=1, now=0.0))])
        assert len(acts) == 1 and acts[0][0] == 5 and acts[0][3] == "/EN1"
        assert st.rfib_routed == 1

    def test_hinted_task_skips_rfib(self):
        (acts,), st = self._both(lambda f, I, D: [_acts(f.on_interest(
            I(make_task_name("/svc", [10], 1), forwarding_hint="/EN2", nonce=1), 1, 0.0))])
        assert acts[0][0] == 6 and st.rfib_routed == 0 and st.fib_routed == 1

    def test_non_task_uses_fib(self):
        (acts,), st = self._both(lambda f, I, D: [_acts(f.on_interest(
            I("/EN1/results/1", nonce=1), 1, now=0.0))])
        assert acts[0][0] == 5 and st.fib_routed == 1

    def test_cs_hit_short_circuits(self):
        name = make_task_name("/svc", [10], 1)

        def drive(f, I, D):
            f.on_interest(I(name, nonce=1), 1, 0.0)
            a1 = _acts(f.on_data(D(name, content=42), in_face=5, now=0.1))
            return [a1, _acts(f.on_interest(I(name, nonce=2), 2, 0.2))]

        (a1, a2), st = self._both(drive)
        assert [a[0] for a in a1] == [1]
        assert a2[0][0] == 2 and a2[0][5] == 42 and a2[0][6]["reuse"] == "cs"
        assert st.cs_hits == 1

    def test_pit_aggregation_forwards_once(self):
        name = make_task_name("/svc", [10], 1)

        def drive(f, I, D):
            a1 = _acts(f.on_interest(I(name, nonce=1), 1, 0.0))
            a2 = _acts(f.on_interest(I(name, nonce=2), 2, 0.0))
            return [a1, a2, _acts(f.on_data(D(name, content=1), 5, 0.1))]

        (a1, a2, a3), _ = self._both(drive)
        assert len(a1) == 1 and a2 == [] and sorted(a[0] for a in a3) == [1, 2]

    def test_corrupted_data_dropped(self):
        name = make_task_name("/svc", [10], 1)

        def drive(f, I, D):
            f.on_interest(I(name, nonce=1), 1, 0.0)
            bad = D(name, content=1)
            bad.signature ^= 0xFF
            return [_acts(f.on_data(bad, 5, 0.1)), _acts(f.on_data(D("/none", 2), 5, 0.2))]

        (a1, a2), st = self._both(drive)
        assert a1 == [] and a2 == [] and st.dropped == 2

    def test_retransmission_and_expiry(self):
        name = make_task_name("/svc", [200], 1)

        def drive(f, I, D):
            a = [_acts(f.on_interest(I(name, nonce=1), 1, 0.0)),
                 _acts(f.on_interest(I(name, nonce=1), 1, 0.1)),
                 _acts(f.on_interest(I(name, nonce=2, retx=1), 1, 0.2))]
            return a + [f.expire(100.0)]

        (a1, a2, a3, n), st = self._both(drive)
        assert a1[0][0] == 6 and a2 == [] and a3[0][0] == 6 and n == 1
        assert st.nonce_duplicates == 1 and st.retx_forwarded == 1


# ---------------------------------------------------------------- TTC path
def _ttc_pair(exec_time=0.5, link=1e-4, window=0.0, num_tables=10, **kw):
    """The reference's single-EN TTC line topology (user -> 0 -> 1 -> 2(EN)),
    built on both packages with the same arguments."""
    nets = []
    for pkg in ("port", "ref"):
        port = pkg == "port"
        params = (LSHParams if port else J.LSHParams)(dim=16, num_tables=num_tables,
                                                       num_probes=8)
        g, ens = (topology if port else jtopo).line_topology(2, link_delay_s=link)
        net = (ReservoirNetwork if port else J.ReservoirNetwork)(
            g, ens, params, seed=0, protocol="ttc", user_link_delay_s=link,
            en_batch_window_s=window, **kw, **(CPU if port else {}))
        net.register_service((edge_node if port else jedge).Service(
            "/svc", execute=lambda x: round(float(np.sum(x)), 5),
            exec_time_s=exec_time, input_dim=16))
        net.add_user("u1", 0)
        net.add_user("u2", 0)
        nets.append(net)
    return nets


def _mix(base: np.ndarray, cos: float, seed: int = 5) -> np.ndarray:
    """A unit vector at exactly ``cos`` similarity to ``base``."""
    rng = np.random.default_rng(seed)
    base = normalize(base)
    r = rng.standard_normal(base.shape).astype(np.float32)
    perp = normalize(r - (r @ base) * base)
    return cos * base + np.sqrt(1.0 - cos * cos) * perp


class TestTTCPath:
    """Fig. 3b exchange: TTC response -> scheduled fetch -> delivery."""

    def _single(self, **kw):
        nets = _ttc_pair(**kw)
        recs = [n.submit_task("u1", "svc", np.ones(16), 0.9, at_time=0.0) for n in nets]
        for n in nets:
            n.run()
        _same_runs(*nets)
        return nets[0], recs[0]

    def test_scheduled_fetch_delivers(self):
        net, rec = self._single(exec_time=0.2)
        en = net.edge_nodes[net.en_nodes[0]]
        assert rec.t_complete >= 0.2 and rec.reuse is None
        assert en.stats["fetches"] >= 1
        assert rec.t_complete == pytest.approx(0.2, abs=0.05)
        assert not net._en_ready

    def test_early_fetch_gets_updated_ttc(self):
        net, rec = self._single(exec_time=0.5)
        assert net.edge_nodes[net.en_nodes[0]].stats["early_fetches"] >= 1
        assert rec.t_complete == pytest.approx(0.5, abs=0.05)

    def test_refetch_rtt_not_inflated(self):
        net, rec = self._single(exec_time=0.5, link=2e-5)
        en = net.edge_nodes[net.en_nodes[0]]
        assert rec.t_complete == pytest.approx(0.5, abs=0.02)
        assert en.stats["early_fetches"] <= 3
        assert en.stats["fetches"] == en.stats["early_fetches"] + 1

    def test_ready_entry_expires_when_never_fetched(self):
        nets = _ttc_pair(exec_time=0.05, en_ready_ttl_s=1.0)
        for net, I in zip(nets, (Interest, J.Interest)):
            en_node = net.en_nodes[0]
            emb = normalize(np.ones(16, np.float32))
            buckets = net.lsh.hash_one(emb)
            name = make_task_name("/svc", buckets, net.lsh_params.index_size_bytes)
            net.at(0.0, net._en_receive, en_node,
                   I(name, app_params={"service": "svc", "input": emb, "threshold": 0.9}))
            net.run()
            assert net.edge_nodes[en_node].stats["ready_expired"] == 1
            assert not net._en_ready
        assert dict(nets[0].edge_nodes[2].stats) == dict(nets[1].edge_nodes[2].stats)

    def test_unsolicited_fetch_counted_not_silent(self):
        for net, I in zip(_ttc_pair(), (Interest, J.Interest)):
            en_node = net.en_nodes[0]
            en = net.edge_nodes[en_node]
            net._en_fetch(en_node, I(en.prefix + "/svc/task/00"))
            assert en.stats["fetch_drops"] == 1

    def test_window_dedupe_intra_batch(self):
        nets = _ttc_pair(exec_time=0.1, window=0.02)
        base = normalize(np.ones(16, np.float32))
        other = _mix(base, 0.8)
        recs = []
        for net in nets:
            recs.append((net.submit_task("u1", "svc", base, 0.6, at_time=0.0),
                         net.submit_task("u2", "svc", other, 0.6, at_time=0.001)))
            net.run()
        _same_runs(*nets)
        r1, r2 = recs[0]
        en = nets[0].edge_nodes[nets[0].en_nodes[0]]
        assert en.stats["executed"] == 1 and en.stats["window_reuse"] == 1
        assert r1.reuse is None and r2.reuse == "en"
        assert r2.similarity == pytest.approx(0.8, abs=1e-5)
        assert r2.t_complete >= 0.1 and abs(r2.t_complete - r1.t_complete) < 0.02


# ------------------------------------------------ offloading protocol (§IV-C)
def _testbed_pair(**kw):
    nets = []
    for pkg in ("port", "ref"):
        port = pkg == "port"
        params = (LSHParams if port else J.LSHParams)(dim=64, num_tables=5, num_probes=8)
        g, ens = (topology if port else jtopo).testbed_topology()
        net = (ReservoirNetwork if port else J.ReservoirNetwork)(
            g, ens, params, seed=0, **kw, **(CPU if port else {}))
        net.register_service((dataset_service if port else jdataset_service)(
            (DATASETS if port else JDATASETS)["stanford_ar"]))
        net.add_user("u1", "fwd1")
        net.add_user("u2", "fwd1")
        nets.append(net)
    return nets


def _drive(nets, n=80, **submit_kw):
    X, _ = make_stream(DATASETS["stanford_ar"], n, seed=2)
    for net in nets:
        t = 0.0
        for i, x in enumerate(X):
            net.submit_task("u1" if i % 2 else "u2", "stanford_ar", x, 0.9, at_time=t,
                            **submit_kw)
            t += 0.05
        net.run()
    _same_runs(*nets)
    return nets[0].metrics


class TestTTCProtocol:
    def test_all_tasks_complete_and_correct(self):
        m = _drive(_testbed_pair(protocol="ttc"))
        assert all(r.t_complete >= 0 for r in m.records)
        for r in m.records:
            assert r.result == r.true_result or r.reuse is not None

    def test_ttc_costs_one_extra_roundtrip_on_scratch(self):
        md = _drive(_testbed_pair(protocol="direct"))
        mt = _drive(_testbed_pair(protocol="ttc"))
        d, t = md.mean_completion(kind=(None,)), mt.mean_completion(kind=(None,))
        assert d < t < d + 0.1
        # EN reuse answers directly (Fig. 3a) regardless of protocol
        assert mt.mean_completion(kind="en") < t


class TestLargeInputPull:
    def test_pull_adds_latency_only_to_scratch(self):
        ms = _drive(_testbed_pair(large_input_bytes=4096), input_size=100_000)
        m0 = _drive(_testbed_pair(large_input_bytes=4096), input_size=0)
        assert ms.mean_completion(kind=(None,)) > m0.mean_completion(kind=(None,))
        en_s, en_0 = ms.mean_completion("en"), m0.mean_completion("en")
        if np.isfinite(en_s) and np.isfinite(en_0):
            assert abs(en_s - en_0) < 0.01


class TestOptOut:
    def test_exact_names_skip_rfib(self):
        name = make_exact_name("/svc", b"payload-bytes")
        assert name == J.make_exact_name("/svc", b"payload-bytes") and "/exact/" in name
        got = []
        for mod, F, I in ((rfib, Forwarder, Interest), (jrfib, J.Forwarder, J.Interest)):
            fwd = F("/f")
            fwd.fib.insert("/svc", 3)
            for e in mod.partition("/svc", ["/EN1"], {"/EN1": [4]}, 1, 256):
                fwd.rfib.insert(e)
            got.append((_acts(fwd.on_interest(I(name, nonce=1), 1, 0.0)),
                        fwd.stats.rfib_routed))
        assert got[0] == got[1]
        assert got[0][0][0][0] == 3 and got[0][1] == 0


# ---------------------------------------------------------------- edge node
P32 = LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)
JP32 = J.LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)


def _vec(seed, d=32):
    return normalize(np.random.default_rng(seed).standard_normal(d))


class TestEdgeNode:
    def _ens(self):
        out = []
        for mod, params, kw in ((edge_node, P32, CPU), (jedge, JP32, {})):
            en = mod.EdgeNode("/en/test", params, store_capacity=128, **kw)
            en.register(mod.Service("/svc", execute=lambda x: float(np.sum(x) > 0),
                                    exec_time_s=0.05, input_dim=32))
            out.append(en)
        return out

    def _task(self, v, thr=0.9, I=Interest):
        buckets = get_lsh(P32, "cpu").hash_one(normalize(v))
        return I(make_task_name("/svc", buckets, P32.index_size_bytes),
                 app_params={"input": normalize(v), "threshold": thr})

    @staticmethod
    def _outcome(o):
        return (o.data.name, o.data.content, o.data.meta, o.reused, o.similarity,
                o.exec_time_s, o.store_size)

    def test_execute_then_reuse(self):
        outs = []
        for en, I in zip(self._ens(), (Interest, J.Interest)):
            v = _vec(11)
            outs.append([self._outcome(en.handle_task(self._task(v, I=I))),
                         self._outcome(en.handle_task(self._task(v, I=I)))])
        assert outs[0] == outs[1]
        (_, c1, _, r1, _, e1, _), (_, c2, _, r2, _, e2, _) = outs[0]
        assert not r1 and e1 > 0 and r2 and e2 == 0.0 and c1 == c2

    def test_ttc_estimation_tracks_exec(self):
        ests = []
        for en, I in zip(self._ens(), (Interest, J.Interest)):
            for i in range(5):
                en.handle_task(self._task(_vec(50 + i), thr=1.1, I=I))
            ests.append(en.estimate_ttc("/svc"))
        assert ests[0] == ests[1] and 0.02 < ests[0] < 0.2

    def test_ttc_response_and_result_name(self):
        got = []
        for en, I in zip(self._ens(), (Interest, J.Interest)):
            t = self._task(_vec(1), I=I)
            resp = en.make_ttc_response(t)
            got.append((resp.name, resp.content, resp.meta, en.result_name(t)))
        assert got[0] == got[1]
        assert got[0][2]["control"] == "ttc" and got[0][1]["en_prefix"] == "/en/test"

    def test_unknown_service_raises(self):
        for en, I in zip(self._ens(), (Interest, J.Interest)):
            with pytest.raises(KeyError):
                en.handle_task(I("/other/task/00", app_params={"input": _vec(1)}))
            assert en.stats["unknown_service"] == 1

    def test_input_pull_chunks(self):
        got = []
        for en, I in zip(self._ens(), (Interest, J.Interest)):
            t = self._task(_vec(1), I=I)
            t.app_params["input_size"] = 20_000
            t.app_params["user_prefix"] = "/user/9"
            t.nonce = 7     # the packages count nonces apart
            got.append([p.name for p in en.input_pull_interests(t, chunk_bytes=8192)])
        assert got[0] == got[1] and len(got[0]) == 3
        assert all(p.startswith("/user/9/input/") for p in got[0])

    def test_stores_live_on_the_node_device(self):
        en = self._ens()[0]
        assert en.device.type == "cpu"
        assert all(s.device.type == "cpu" for s in en.stores.values())


class TestEndToEnd:
    def _run(self, mode="reservoir", n=120, threshold=0.85):
        nets = []
        X, _ = make_stream(dataclasses.replace(DATASETS["cctv1"], dim=32), n, seed=3)
        for pkg in ("port", "ref"):
            port = pkg == "port"
            g, ens = (topology if port else jtopo).testbed_topology()
            net = (ReservoirNetwork if port else J.ReservoirNetwork)(
                g, ens, P32 if port else JP32, mode=mode, seed=0, **(CPU if port else {}))
            spec = dataclasses.replace((DATASETS if port else JDATASETS)["cctv1"], dim=32)
            net.register_service((dataset_service if port else jdataset_service)(
                spec, exec_time_s=(0.07, 0.1)))
            net.add_user("u1", "fwd1")
            net.add_user("u2", "fwd1")
            t = 0.0
            for i, x in enumerate(X):
                net.submit_task("u1" if i % 2 else "u2", spec.name, x, threshold, at_time=t)
                t += 0.04
            net.run()
            nets.append(net)
        _same_runs(*nets)
        return nets[0]

    def test_all_complete_reuse_faster_executions_bounded(self):
        net = self._run()
        m = net.metrics
        assert all(r.t_complete >= 0 for r in m.records)
        en = m.mean_completion(kind="en")
        assert en < m.mean_completion(kind=(None,))
        if m.by_reuse(("cs", "user")):
            assert m.mean_completion(("cs", "user")) < en
        executed = sum(e.stats["executed"] for e in net.edge_nodes.values())
        reused = sum(e.stats["reused"] for e in net.edge_nodes.values())
        assert executed >= 1 and executed + reused <= len(m.records)

    def test_reuse_accuracy_high_for_high_threshold(self):
        assert self._run(threshold=0.95).metrics.accuracy() > 0.9

    def test_icedge_mode_runs_and_is_slower(self):
        res = self._run(mode="reservoir")
        ice = self._run(mode="icedge")
        assert ice.metrics.mean_completion() > res.metrics.mean_completion() * 0.8
