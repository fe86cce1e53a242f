"""insert_ms: the replicas' inserts a round (``ReplicaEngine.commit_execution``
→ ``ReuseStore.insert_batch`` at capacity, evicting, then the device sync and
the Content Store), host-clock spans summed over the window ÷ rounds."""


def read(t):
    return 1e3 * t.span_sum_s("insert") / len(t.rounds) if t.rounds else None
