"""hit_share: tasks answered by reuse (Content Store or store hit) as a share
of the tasks attempted in the window, from each ``ServeResult.reuse``."""


def read(t):
    n = sum(len(r) for r in t.rounds)
    if not n:
        return None
    return 100.0 * sum(int((r.kind == 0).sum() + (r.kind == 1).sum()) for r in t.rounds) / n
