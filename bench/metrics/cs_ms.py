"""cs_ms: the replicas' Content Store work a round: the program's
``replica.cs`` spans (``ReplicaEngine.handle_batch``'s lookup and
coalescing loop and its EN-hit admissions, ``commit_execution``'s inserts),
summed over the window ÷ rounds."""
from bench import spans


def read(t):
    return spans.per_round_ms(t, "replica.cs")
