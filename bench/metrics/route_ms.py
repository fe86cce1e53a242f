"""route_ms: the router's time a round (``ReuseRouter.route_batch``: the
hash launch and the owners' vote), host-clock spans summed over the window
÷ rounds."""


def read(t):
    return 1e3 * t.span_sum_s("route") / len(t.rounds) if t.rounds else None
