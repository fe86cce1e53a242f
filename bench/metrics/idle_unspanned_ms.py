"""idle_unspanned_ms: device idle time a round with no program span open
(the harness's own loop between submissions, and whatever the program
leaves unspanned): the window's idle time (no device operation running in
the trace) split at the program's span edges (``spans.idle_by_span``),
its ``unspanned`` share ÷ rounds.  Also prints the whole split to standard
error, the largest ten first."""
import sys

from bench import spans


def read(t):
    got = spans.recorded(t)
    if got is None or not t.events or not t.rounds:
        return None
    idle = spans.idle_by_span(t, got)
    top = sorted(idle.items(), key=lambda kv: kv[1], reverse=True)[:10]
    print("idle by program span (s): " + ", ".join(f"{n} {s:.6f}" for n, s in top),
          file=sys.stderr, flush=True)
    return 1e3 * idle.get("unspanned", 0.0) / len(t.rounds)
