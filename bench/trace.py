"""The traced run: ``torch.profiler`` over the whole window (device activity
only), its device operations placed on the host clock, and what the
per-layer readers (``metrics/*.py``) read.

The profiler's clock is tied to the host's by a marker: after the profiler
starts and the device is idle, one ``torch.cuda._sleep`` kernel is launched
at a known host time; its start in the trace gives the offset (good to the
launch latency, some microseconds).  Idle gaps are then labelled by the
harness span open on the host at their middle: route, query, insert, exec,
or other.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

K6_KERNEL = re.compile(r"(^|\W)flash_(tc_)?kernel\b")
K1_KERNEL = re.compile(r"(^|\W)(probed|sparse)_kernel\b")


@dataclasses.dataclass
class Trace:
    """What a traced window leaves for the readers."""
    window_s: float
    rounds: List[Any]                   # the window's Rounds
    clients: int
    config: Mapping
    spans: Any                          # cell.Spans
    start_ns: int                       # window on the host clock
    end_ns: int
    events: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)
    # (name, start ns on the host clock, duration ns) of each device operation

    def span_sum_s(self, label: str) -> float:
        return sum(e - s for lb, s, e in self.spans.items
                   if lb == label and s >= self.start_ns and e <= self.end_ns) / 1e9

    def kernel_s(self, pattern: re.Pattern) -> float:
        return sum(d for n, _, d in self.events if pattern.search(n)) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """Merged intervals in which some device operation ran, inside the
        window."""
        iv = sorted((max(s, self.start_ns), min(s + d, self.end_ns))
                    for _, s, d in self.events if s + d > self.start_ns and s < self.end_ns)
        out: List[List[int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def idle_gaps(self) -> List[Tuple[str, int, int]]:
        """(label, start, end) of each interval of the window with no device
        operation running, labelled by the span open at its middle (the
        harness's spans do not nest)."""
        spans = sorted(((s, e, lb) for lb, s, e in self.spans.items), key=lambda t: t[0])
        starts = np.asarray([s for s, _, _ in spans], np.int64)
        edges = [self.start_ns] + [t for iv in self.busy() for t in iv] + [self.end_ns]
        out = []
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            k = int(np.searchsorted(starts, mid, side="right")) - 1
            label = spans[k][2] if k >= 0 and spans[k][1] >= mid else "other"
            out.append((label, s, e))
        return out

    def breakdown(self) -> Dict[str, List[List]]:
        by_op: Dict[str, float] = {}
        for n, _, d in self.events:
            by_op[n] = by_op.get(n, 0.0) + d / 1e9
        idle: Dict[str, float] = {}
        for lb, s, e in self.idle_gaps():
            idle[lb] = idle.get(lb, 0.0) + (e - s) / 1e9
        top = sorted(by_op.items(), key=lambda kv: kv[1], reverse=True)[:10]
        gaps = sorted(idle.items(), key=lambda kv: kv[1], reverse=True)[:10]
        return {"device_ops": [[n[:200], s] for n, s in top],
                "idle_gaps": [[f"idle during {n}", s] for n, s in gaps]}


class Profiler:
    """``torch.profiler`` over a window, on a CUDA device; on the CPU it
    records nothing and the device readers return nothing."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.offset_ns = 0

    def __enter__(self) -> "Profiler":
        if self.device.type != "cuda":
            return self
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._marker_ns = time.perf_counter_ns()
        torch.cuda._sleep(20000)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc) -> None:
        if self.prof is not None:
            torch.cuda.synchronize(self.device)
            self.prof.__exit__(*exc)

    def events(self) -> List[Tuple[str, int, int]]:
        """Device operations, their starts on the host's perf_counter clock."""
        if self.prof is None:
            return []
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
                raw.append((e.name(), int(start), int(e.duration_ns())))
        if not raw:
            return []
        raw.sort(key=lambda t: t[1])
        marker = next((r for r in raw if "sleep" in r[0].lower() or "spin" in r[0].lower()),
                      raw[0])
        self.offset_ns = marker[1] - self._marker_ns
        return [(n, s - self.offset_ns, d) for n, s, d in raw if (n, s, d) != marker]


def device_block(t: Optional[Trace]) -> Dict[str, float]:
    if t is None or not t.events:
        return {}
    return {"busy_s": t.busy_s(), "window_s": (t.end_ns - t.start_ns) / 1e9}
