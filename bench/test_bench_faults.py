"""A run with the timed path broken underneath has to come out not correct:
once for each fault a serving cell can have (one chip: no exchange between
chips to leave out)."""
import json

import pytest
import torch

from bench import run as bench_run
from bench.spec import ROOT
from bench.tiny import LIMITS, tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def run_tiny(mix="cctv"):
    cell, arch = tiny_cell(mix)
    return bench_run.run_cell(cell, BENCH, 2 ** 31 + 7, 0.5, False, torch.device("cpu"),
                              arch=arch, limits=LIMITS)


def altered_token(monkeypatch):
    """A token altered where it is produced: the executor's argmax + 1."""
    from repro_torch.launch import serve
    make = serve.make_executor

    def make_executor(model, seq_len):
        execute = make(model, seq_len)
        return lambda reqs: [t + 1 for t in execute(reqs)]
    monkeypatch.setattr(serve, "make_executor", make_executor)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: each store hit answers with
    the next hit's result."""
    from repro_torch.serving import ReplicaEngine
    query = ReplicaEngine.query_reuse

    def query_reuse(self, service, embs, thresholds):
        out = query(self, service, embs, thresholds)
        hits = [i for i, (_, _, idx) in enumerate(out) if idx is not None]
        moved = list(out)
        for a, b in zip(hits, hits[1:] + hits[:1]):
            moved[a] = (out[b][0],) + tuple(out[a][1:])
        return moved
    monkeypatch.setattr(ReplicaEngine, "query_reuse", query_reuse)


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged: once the stores are full,
    an insert stores nothing."""
    from repro_torch.core.reuse_store import ReuseStore
    insert = ReuseStore.insert_batch

    def insert_batch(self, embeddings, results, buckets=None):
        if len(self) >= self.capacity:
            return []
        return insert(self, embeddings, results, buckets=buckets)
    monkeypatch.setattr(ReuseStore, "insert_batch", insert_batch)


def half_batch(monkeypatch):
    """Half of the batch left out: a replica serves the first half of its
    share and gives the rest the first half's answers."""
    from repro_torch.serving import ReplicaEngine
    handle = ReplicaEngine.handle_batch

    def handle_batch(self, reqs, now=None):
        half = handle(self, reqs[:(len(reqs) + 1) // 2], now=now)
        return half + half[:len(reqs) - len(half)]
    monkeypatch.setattr(ReplicaEngine, "handle_batch", handle_batch)


@pytest.mark.parametrize("fault", [altered_token, altered_answer, state_unchanged, half_batch],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run_tiny()
    assert not res["correct"]
