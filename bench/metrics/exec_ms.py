"""exec_ms: the executor's time a round (``ReplicaEngine.execute_batch`` →
``make_executor`` → ``DecoderLM.prefill``, ending in the host read of the
tokens), host-clock spans summed over the window ÷ rounds."""


def read(t):
    return 1e3 * t.span_sum_s("exec") / len(t.rounds) if t.rounds else None
