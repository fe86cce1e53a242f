"""query_wait_ms: the fused query's host reads a round: the program's
``store.read`` spans (``ReuseStore._query_fused`` reading K1's val and idx
and the counts, which waits for the device), summed over the window ÷
rounds."""
from bench import spans


def read(t):
    return spans.per_round_ms(t, "store.read")
