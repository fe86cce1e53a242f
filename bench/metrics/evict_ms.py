"""evict_ms: the stores' inserts at capacity a round: the program's
``store.evict`` spans (``ReuseStore.insert_batch``'s scalar
evict-and-insert loop), summed over the window ÷ rounds; 0 where no insert
evicted."""
from bench import spans


def read(t):
    return spans.per_round_ms(t, "store.evict")
