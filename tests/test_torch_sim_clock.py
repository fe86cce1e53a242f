"""The port's event loop, sanitizer, tracer and profiler, on the CPU.

Mirrors of the reference's tests of the same primitives
(tests/test_async_serving.py::TestEventLoop, tests/test_obs.py::TestTracer
and ::TestArming, the network-free cases of
tests/test_analysis.py::TestSanitizerTrips and ::TestZeroCostDisarmed), a
seeded schedule run through both packages' loops (same order, same clock),
and a profiler test over the port's async engine in place of the
reference's network-based one.
"""
import json

import numpy as np
import pytest

from repro.core.sim_clock import EventLoop as JLoop
from repro_torch.analysis import sanitizer as san_mod
from repro_torch.analysis.sanitizer import SanitizerError, env_enabled
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.reuse_store import ReuseStore
from repro_torch.core.sim_clock import EventLoop, Future
from repro_torch.kernels import ops
from repro_torch.obs import Profiler, Tracer
from repro_torch.obs.trace import TRACK_TID_BASE
from repro_torch.serving import AsyncServingEngine, ReplicaEngine, ServeRequest

CPU = "cpu"
P = LSHParams(dim=16, num_tables=2, num_probes=4, seed=3)


def _vec(seed, d=16):
    return normalize(np.random.default_rng(seed).standard_normal(d))


# --------------------------------------------------------------- event loop
class TestEventLoop:
    def test_ordering_and_clock(self):
        loop = EventLoop()
        seen = []
        loop.at(2.0, seen.append, "b")
        loop.at(1.0, seen.append, "a")
        loop.at(2.0, seen.append, "c")  # same time: insertion order
        assert loop.run() == 2.0
        assert seen == ["a", "b", "c"]

    def test_timer_cancel(self):
        loop = EventLoop()
        seen = []
        t = loop.at(1.0, seen.append, "x")
        loop.at(2.0, seen.append, "y")
        t.cancel()
        loop.run()
        assert seen == ["y"]

    def test_run_until(self):
        loop = EventLoop()
        seen = []
        loop.at(1.0, seen.append, 1)
        loop.at(5.0, seen.append, 5)
        loop.run(until=2.0)
        assert seen == [1] and len(loop) == 1 and loop.now == 2.0

    def test_nested_scheduling(self):
        loop = EventLoop()
        seen = []
        loop.at(1.0, lambda: loop.call_later(0.5, seen.append, "late"))
        loop.run()
        assert seen == ["late"] and loop.now == 1.5

    def test_empty_loop_is_falsy(self):
        # why AsyncServingEngine takes ``loop if loop is not None``
        assert not EventLoop() and len(EventLoop()) == 0

    def test_future_first_result_wins(self):
        fut = Future()
        got = []
        fut.add_done_callback(lambda f: got.append(f.result))
        assert fut.try_set_result("first", now=1.0)
        assert not fut.try_set_result("second", now=2.0)
        assert fut.result == "first" and fut.resolved_at == 1.0
        assert got == ["first"]
        with pytest.raises(RuntimeError):
            fut.set_result("third")
        fut.add_done_callback(lambda f: got.append("immediate"))
        assert got == ["first", "immediate"]

    def test_future_exception_then_and_propagate(self):
        a, out = Future(), Future()
        derived = a.then(lambda v: v * 2)
        a.add_done_callback(lambda f: f.propagate(out))
        a.try_set_exception(ValueError("boom"), now=3.0)
        assert isinstance(derived.exception, ValueError)
        assert isinstance(out.exception, ValueError) and out.resolved_at == 3.0
        with pytest.raises(ValueError):
            _ = out.result
        ok = Future()
        doubled = ok.then(lambda v: v * 2)
        ok.try_set_result(21, now=1.5)
        assert doubled.result == 42 and doubled.resolved_at == 1.5

    def test_repeating_timer_stops_when_idle(self):
        loop = EventLoop()
        ticks = []
        rt = loop.every(0.25, lambda: ticks.append(loop.now) or len(ticks) < 3)
        assert not rt.running
        rt.kick()
        loop.run()
        assert ticks == [0.25, 0.5, 0.75] and not rt.running


class TestLoopCrossPackage:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_schedule_same_order_and_clock(self, seed):
        """Random times with ties, nested call_later, cancels and a partial
        drain: the port's loop pops in the reference's (t, seq) order."""
        def run(loop_cls):
            rng = np.random.default_rng(seed)
            loop = loop_cls()
            order = []

            def fire(tag):
                order.append((tag, loop.now))
                if tag % 3 == 0:
                    loop.call_later(float(rng.integers(0, 4)) * 0.125, fire, tag + 1000)

            timers = [loop.at(float(rng.integers(0, 20)) * 0.0625, fire, i) for i in range(60)]
            for t in timers[::7]:
                t.cancel()
            loop.run(until=0.5)
            mid = loop.now
            loop.run()
            return order, mid, loop.now, loop.processed

        assert run(EventLoop) == run(JLoop)


# ------------------------------------------------------------------ tracer
class TestTracer:
    def test_span_lifecycle(self):
        tr = EventLoop(trace=True).tracer
        sid = tr.begin("task", "task", 7, t=1.0, user="u1")
        assert tr.open_spans() == [(sid, "task", "task", 7)]
        tr.end(sid, t=3.5, outcome="completed")
        assert tr.open_spans() == []
        tr.end(sid, t=9.0)  # double-close is a no-op, first close wins
        (ev,) = tr.events
        assert ev["ph"] == "X" and ev["ts"] == 1.0e6 and ev["dur"] == 2.5e6
        assert ev["tid"] == 7
        assert ev["args"] == {"user": "u1", "outcome": "completed"}

    def test_abandon_marks_outcome(self):
        tr = EventLoop(trace=True).tracer
        sid = tr.begin("offload", "federation", 3, t=0.0)
        tr.abandon(sid, t=1.0, why="peer-dead")
        assert not tr.open_spans()
        assert tr.events[-1]["args"]["outcome"] == "peer-dead"

    def test_tracks_and_export(self, tmp_path):
        tr = EventLoop(trace=True).tracer
        t1 = tr.track("gossip")
        assert t1 >= TRACK_TID_BASE
        assert tr.track("gossip") == t1            # stable
        assert tr.track("migrate") == t1 + 1       # distinct
        tr.name_task(5, "task u1/svc")
        tr.instant("gossip-round", "gossip", t1, t=0.5, round=1)
        path = tmp_path / "trace.json"
        doc = tr.export(str(path))
        loaded = json.loads(path.read_text())
        assert loaded == doc
        names = {e["args"]["name"] for e in loaded["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert {"gossip", "migrate", "task u1/svc"} <= names
        assert loaded["displayTimeUnit"] == "ms"

    def test_engine_dispatch_events(self):
        """The async engine marks each traced task's dispatch on its track."""
        eng = AsyncServingEngine(P, [ReplicaEngine(0, P, _execute, device=CPU)],
                                 loop=EventLoop(trace=True), device=CPU)
        eng.submit(ServeRequest(0, "svc", _vec(4), trace_tid=11))
        eng.submit(ServeRequest(1, "svc", _vec(5)))          # untraced
        eng.drain()
        evs = [e for e in eng.loop.tracer.events if e["name"] == "engine-dispatch"]
        assert [(e["tid"], e["args"]["task"], e["ph"]) for e in evs] == [(11, 11, "i")]
        assert evs[0]["ts"] == pytest.approx(0.005e6)


class TestArming:
    def test_disarmed_by_default_and_kwarg(self, monkeypatch):
        for var in ("RESERVOIR_TRACE", "RESERVOIR_PROFILE", "RESERVOIR_SANITIZE"):
            monkeypatch.delenv(var, raising=False)
        loop = EventLoop()
        assert loop.tracer is None and loop.profiler is None and loop.sanitizer is None
        armed = EventLoop(trace=True, profile=True, sanitize=True)
        assert isinstance(armed.tracer, Tracer) and isinstance(armed.profiler, Profiler)
        assert armed.sanitizer is not None

    def test_env_arming_and_kwarg_override(self, monkeypatch):
        monkeypatch.setenv("RESERVOIR_TRACE", "1")
        monkeypatch.setenv("RESERVOIR_PROFILE", "yes")
        loop = EventLoop()
        assert loop.tracer is not None and loop.profiler is not None
        off = EventLoop(trace=False, profile=False)
        assert off.tracer is None and off.profiler is None
        monkeypatch.setenv("RESERVOIR_TRACE", "0")
        assert EventLoop().tracer is None


# ---------------------------------------------------------------- profiler
def _execute(reqs):
    return [f"r{r.request_id}" for r in reqs]


class TestProfiler:
    def test_ranked_sites_dispatches_and_report(self):
        """A flush of 80 queries takes the fused path (one dispatch), the
        admissions none: the report ranks the engine's callback sites."""
        p = LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)
        rep = ReplicaEngine(0, p, _execute, device=CPU)
        x = normalize(np.random.default_rng(0).standard_normal((300, 32)))
        rep._store("svc").insert_batch(x[:200], list(range(200)))
        eng = AsyncServingEngine(p, [rep], loop=EventLoop(profile=True), max_batch=128,
                                 max_wait_s=0.005, exec_time_fn=lambda *a: 0.01, device=CPU)
        for i in range(80):
            eng.submit(ServeRequest(i, "svc", x[120 + i], threshold=0.9))
        eng.drain()
        prof = eng.loop.profiler
        prof.add_counter_source("store_entries", lambda: len(rep.stores["svc"]))
        rows = prof.rows()
        walls = [r["wall_s"] for r in rows]
        assert walls == sorted(walls, reverse=True) and all(r["count"] > 0 for r in rows)
        by_site = {r["site"]: r for r in rows}
        assert by_site["AsyncServingEngine._on_flush"]["dispatches"] == 1
        assert all(r["retraces"] == 0 for r in rows)     # the port has no jit
        assert rep.stores["svc"].fused_queries == 80
        totals = prof.totals()
        assert totals["events"] == sum(r["count"] for r in rows) == eng.loop.processed
        assert totals["dispatches"] == 1 and totals["store_entries"] == len(rep.stores["svc"])
        report = prof.report(top=5)
        assert "EventLoop profile" in report and rows[0]["site"] in report
        d = prof.to_dict()
        assert d["sites"] == rows and d["totals"]["events"] == totals["events"]

    def test_counts_follow_the_ops_module(self):
        prof = EventLoop(profile=True).profiler
        mark = prof.begin()
        ops.FUSED_DISPATCH_COUNT += 2
        try:
            prof.end("site", mark)
        finally:
            ops.FUSED_DISPATCH_COUNT -= 2
        assert prof.rows()[0]["dispatches"] == 2


# ------------------------------------------------------------ sanitizer trips
class TestSanitizerTrips:
    def test_future_double_resolve(self):
        loop = EventLoop(sanitize=True)
        fut = Future()

        def bad():
            fut.set_result("first")
            fut.set_result("second")

        loop.at(0.5, bad)
        with pytest.raises(SanitizerError) as ei:
            loop.run()
        assert ei.value.check == "future-double-resolve"
        assert "bad" in ei.value.provenance and "t=0.5" in ei.value.provenance

    def test_future_resolve_after_exception(self):
        loop = EventLoop(sanitize=True)
        fut = Future()

        def bad():
            fut.try_set_exception(RuntimeError("backend died"))
            fut.try_set_result("late value silently dropped")

        loop.at(1.0, bad)
        with pytest.raises(SanitizerError) as ei:
            loop.run()
        assert ei.value.check == "future-resolve-after-exception"

    def test_allow_late_quiets_designed_race(self):
        loop = EventLoop(sanitize=True)
        fut = Future()

        def designed():
            fut.allow_late()
            fut.try_set_exception(RuntimeError("timeout abort"))
            assert fut.try_set_result("slow remote reply") is False

        loop.at(1.0, designed)
        loop.run()
        assert fut.exception is not None

    def test_timer_in_past(self):
        loop = EventLoop(sanitize=True)
        loop.run(until=5.0)
        with pytest.raises(SanitizerError) as ei:
            loop.at(1.0, lambda: None)
        assert ei.value.check == "timer-in-past"
        assert ei.value.details["t"] == 1.0

    def test_excused_loss_passes_idle_audit(self):
        loop = EventLoop(sanitize=True)
        san = loop.sanitizer
        table = {"/svc/task/LOST": object()}
        san.add_idle_check(lambda: [
            san.fail("pit-leak", f"leaked {n}")
            for n in sorted(table) if not san.is_excused(n)])
        loop.at(0.1, lambda: None)
        with pytest.raises(SanitizerError):
            loop.run()
        san.note_loss("/svc/task/LOST", "chaos link drop")
        loop.at(loop.now + 0.1, lambda: None)
        loop.run()  # excused: no error

    def test_mirror_divergence_carries_provenance(self):
        store = ReuseStore(P, capacity=64, page_size=8, device=CPU)
        store.sanitize = True
        for i in range(12):
            store.insert(_vec(i), f"r{i}")
        store.sync_device(ensure=True)  # clean + audited
        store._pages[0][0, 0] += 1.0    # host truth changed behind the dirty set
        with pytest.raises(SanitizerError) as ei:
            store.audit_mirror()
        assert ei.value.check == "mirror-divergence" and ei.value.details["page"] == 0
        assert ei.value.provenance == ""       # outside an armed loop
        loop = EventLoop(sanitize=True)

        def audit():
            store.audit_mirror()

        loop.at(0.25, audit)
        with pytest.raises(SanitizerError) as ei:
            loop.run()
        assert "audit" in ei.value.provenance and "t=0.25" in ei.value.provenance

    def test_dirty_page_conservation(self):
        store = ReuseStore(P, capacity=64, page_size=8, device=CPU)
        store.sanitize = True
        store.insert(_vec(1), "r")
        store.sync_device(ensure=True)
        store._dirty.add(0)
        with pytest.raises(SanitizerError) as ei:
            store._audit_sync([])
        assert ei.value.check == "dirty-page-conservation"

    def test_slot_table_trailing_invariant(self):
        store = ReuseStore(P, capacity=64, page_size=8, device=CPU)
        store.sanitize = True
        idx = store.insert(_vec(1), "r")
        b = int(store._buckets_of[idx][0])
        f = int(store._fill[0, b])
        store._slots[0, b, f] = 99
        with pytest.raises(SanitizerError) as ei:
            store._audit_bucket_rows([(0, b)])
        assert ei.value.check == "slot-table-trailing-invalid"

    def test_migration_id_loss(self):
        loop = EventLoop(sanitize=True)
        loop.sanitizer.note_migration_out("/en/e1/svc/migrate/0", 5, 0xABC)
        loop.at(0.1, lambda: None)
        with pytest.raises(SanitizerError) as ei:
            loop.run()  # idle: sent but never delivered nor excused
        assert ei.value.check == "migration-id-loss"

    def test_migration_corruption_and_duplication(self):
        name = "/en/e1/svc/migrate/1"
        san = EventLoop(sanitize=True).sanitizer
        san.note_migration_out(name, 5, 0xABC)
        with pytest.raises(SanitizerError) as ei:
            san.note_migration_in(name, 4, 0xABC)  # an entry vanished
        assert ei.value.check == "migration-id-conservation"
        san2 = EventLoop(sanitize=True).sanitizer
        san2.note_migration_out(name, 5, 0xABC)
        san2.note_migration_in(name, 5, 0xABC)
        with pytest.raises(SanitizerError) as ei:
            san2.note_migration_in(name, 5, 0xABC)  # replayed batch
        assert ei.value.check == "migration-duplicate-delivery"
        with pytest.raises(SanitizerError) as ei:
            san2.note_migration_out(name, 5, 0xABC)
        assert ei.value.check == "migration-duplicate-send"

    def test_migration_excused_loss_settles(self):
        loop = EventLoop(sanitize=True)
        name = "/en/e1/svc/migrate/2"
        loop.sanitizer.note_migration_out(name, 5, 0xABC)
        loop.sanitizer.note_migration_lost(name, "destination crashed before admit")
        loop.at(0.1, lambda: None)
        loop.run()  # excused cache loss: settles clean


class TestZeroCostDisarmed:
    def test_env_enabled_parsing(self, monkeypatch):
        monkeypatch.delenv("RESERVOIR_SANITIZE", raising=False)
        assert env_enabled() is False
        monkeypatch.setenv("RESERVOIR_SANITIZE", "1")
        assert env_enabled() is True
        monkeypatch.setenv("RESERVOIR_SANITIZE", "0")
        assert env_enabled() is False

    def test_sanitizer_off_zero_cost(self):
        loop = EventLoop(sanitize=False)
        depth_seen = []
        loop.at(0.1, lambda: depth_seen.append(len(san_mod._STACK)))
        loop.run()
        assert depth_seen == [0]  # no sanitizer context pushed
        fut = Future()
        assert fut.try_set_result(1) is True
        assert fut.try_set_result(2) is False
        with pytest.raises(RuntimeError) as ei:
            fut.set_result(3)
        assert not isinstance(ei.value, SanitizerError)
        armed = EventLoop(sanitize=True)
        armed.at(0.1, lambda: depth_seen.append(san_mod.current() is armed.sanitizer))
        armed.run()
        assert depth_seen == [0, True] and san_mod.current() is None

    def test_disarmed_run_bit_identical(self):
        def trace(sanitize):
            loop = EventLoop(sanitize=sanitize)
            order = []
            loop.at(0.2, lambda: order.append(("b", loop.now)))
            loop.at(0.1, lambda: order.append(("a", loop.now)))
            loop.at(0.1, lambda: loop.call_later(
                0.05, lambda: order.append(("c", loop.now))))
            loop.run()
            return order, loop.now, loop.processed

        assert trace(False) == trace(True)
