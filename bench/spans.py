"""The program's own spans in a traced window, for the per-layer readers.

The port records nested spans of its serving path on the host's
``perf_counter_ns`` clock (``repro_torch/obs/trace.py``: the wall recorder,
armed while ``torch.profiler`` records, so the traced run's profiler arms
it).  That is the clock ``trace.Profiler`` places the device operations on,
so a span and a device operation share one timeline.  A span is (id,
parent id, name, start ns, end ns, args).

A program without the recorder, or a window it did not record, gives
``None`` here, and the readers then return nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Span = Tuple[int, int, str, int, int, Optional[dict]]
ROOT = "fleet.submit"        # one a round: the window was recorded if it has one


def recorded(t) -> Optional[List[Span]]:
    """Every program span that overlaps the window, or None where the
    program records none there."""
    try:
        from repro_torch.obs import trace as obs_trace
    except ImportError:
        return None
    wall = getattr(obs_trace, "wall", None)
    tracer = wall() if wall is not None else None
    if tracer is None:
        return None
    spans = [s for s in tracer.spans if s[3] < t.end_ns and s[4] > t.start_ns]
    if not any(s[2] == ROOT and s[3] >= t.start_ns and s[4] <= t.end_ns for s in spans):
        return None
    return spans


def inside(t, spans: List[Span]) -> List[Span]:
    """The spans that lie wholly inside the window (as ``Trace.span_sum_s``
    counts the harness's)."""
    return [s for s in spans if s[3] >= t.start_ns and s[4] <= t.end_ns]


def per_round_ms(t, name: str) -> Optional[float]:
    """The named spans' time summed over the window ÷ rounds, in ms."""
    spans = recorded(t)
    if spans is None or not t.rounds:
        return None
    return sum(e - s for _, _, n, s, e, _ in inside(t, spans) if n == name) / 1e6 / len(t.rounds)


def self_ns(spans: List[Span], name: str) -> int:
    """The named spans' own time: each one's duration less its children's
    (children of one span run one after another, so they do not overlap)."""
    ids = {s[0]: s[4] - s[3] for s in spans if s[2] == name}
    return sum(ids.values()) - sum(e - s for _, p, _, s, e, _ in spans if p in ids)


def idle_by_span(t, spans: List[Span]) -> Dict[str, float]:
    """Seconds of the window in which no device operation ran, split at
    every span edge: each piece goes to the innermost program span open
    over it, or to ``unspanned``.  The pieces sum to the window less
    ``t.busy()``."""
    depth: Dict[int, int] = {}
    for sid, parent, *_ in sorted(spans):      # a parent's id is below its children's
        depth[sid] = depth.get(parent, 0) + 1

    edges = []
    for sid, _, name, s, e, _ in spans:
        s, e = max(s, t.start_ns), min(e, t.end_ns)
        if e > s:
            d = depth[sid]
            edges.append((s, 1, d, sid, name))
            edges.append((e, 0, -d, sid, name))
    edges.sort()
    # label segments: (start, end, innermost span open) over the window
    segs: List[Tuple[int, int, str]] = []
    open_: Dict[int, Tuple[int, int, str]] = {}
    at = t.start_ns
    for when, kind, d, sid, name in edges:
        if when > at:
            label = max(open_.values())[2] if open_ else "unspanned"
            segs.append((at, when, label))
            at = when
        if kind:
            open_[sid] = (d, when, name)
        else:
            open_.pop(sid, None)
    if t.end_ns > at:
        segs.append((at, t.end_ns, "unspanned"))
    # the idle gaps: the window less the merged device intervals
    bounds = [t.start_ns] + [x for iv in t.busy() for x in iv] + [t.end_ns]
    gaps = [(s, e) for s, e in zip(bounds[0::2], bounds[1::2]) if e > s]
    out: Dict[str, float] = {}
    i = 0
    for gs, ge in gaps:
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < ge:
            s, e, label = segs[j]
            piece = min(e, ge) - max(s, gs)
            if piece > 0:
                out[label] = out.get(label, 0.0) + piece / 1e9
            j += 1
    return out
