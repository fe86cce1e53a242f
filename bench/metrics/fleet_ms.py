"""fleet_ms: the fleet's own time a round: the program's ``fleet.submit``
spans (``ServingFleet.submit_batch_sync``: stacking the embeddings,
grouping the tasks by owner, gathering the results) less their children
(``router.route``, ``replica.handle``, garbage-collector passes), summed
over the window ÷ rounds."""
from bench import spans


def read(t):
    got = spans.recorded(t)
    if got is None or not t.rounds:
        return None
    return spans.self_ns(spans.inside(t, got), "fleet.submit") / 1e6 / len(t.rounds)
