"""query_ms: the replicas' naming and store queries a round
(``ReplicaEngine.embed_batch`` and ``query_reuse`` → ``ReuseStore.query_batch``
→ the fused query), host-clock spans summed over the window ÷ rounds."""


def read(t):
    return 1e3 * t.span_sum_s("query") / len(t.rounds) if t.rounds else None
