"""upload_mb: host-to-device bytes of the stores' mirrors a round: the
``bytes`` argument of the program's ``store.sync`` spans (dirty embedding
pages and slot-table slabs, ``ReuseStore._sync``), summed over the window ÷
rounds, in MB (10^6 bytes)."""
from bench import spans


def read(t):
    got = spans.recorded(t)
    if got is None or not t.rounds:
        return None
    total = sum((args or {}).get("bytes", 0)
                for _, _, name, _, _, args in spans.inside(t, got) if name == "store.sync")
    return total / 1e6 / len(t.rounds)
