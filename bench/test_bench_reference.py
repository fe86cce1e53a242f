"""The plain references agree with the port on the CPU at a tiny size: the
LSH, the reuse decisions of a fleet round by round, and the logits of the
configurations' reduced models."""
import json

import numpy as np
import pytest
import torch

from bench.reference import dense_lm
from bench.reference.reuse import Fleet, Lsh, rotations, unit
from bench.spec import ROOT
from bench.tiny import tiny_cell
from bench.traffic import Traffic
from bench.weights import Weights

LSH = json.loads((ROOT / "bench/configs/qwen3-1.7b.json").read_text())["deployment"]["lsh"]


def test_lsh_matches_the_port():
    from repro_torch.core.lsh import LSHParams, get_lsh, sample_params
    params = LSHParams(**LSH)
    assert np.array_equal(rotations(LSH)[:, None], sample_params(params)[0])
    x = Traffic(json.loads((ROOT / "bench/traffic/fresh.json").read_text()), 3, 512,
                "cpu").rounds(1)[0]
    ref = Lsh(LSH).hash(unit(x))
    port = get_lsh(params, "cpu")
    assert np.array_equal(ref.buckets, port.hash_batch(x).numpy())
    probes = port.probe_batch(x).numpy()
    assert np.array_equal(ref.top[..., :LSH["num_probes"]], probes)


@pytest.mark.parametrize("mix", ["cctv", "fresh"])
def test_reuse_decisions_match_the_port(mix):
    """The port's fleet and the float64 reference answer the same fill and
    rounds alike, task for task (replica, kind, result)."""
    from repro_torch.core.lsh import LSHParams
    from repro_torch.serving import ReplicaEngine, ServeRequest, ServingFleet
    cell, _ = tiny_cell(mix, capacity=1500)
    dep = cell.deployment
    tr = Traffic(cell.traffic, 11, 160, "cpu")
    lsh = LSHParams(**dep["lsh"])
    execute = lambda reqs: [(r.request_id, 0) for r in reqs]  # noqa: E731
    reps = [ReplicaEngine(i, lsh, execute, cs_capacity=dep["cs_capacity"],
                          store_capacity=dep["store_capacity"], device="cpu") for i in range(2)]
    fleet = ServingFleet(lsh, reps, device="cpu")
    hist = tr.history(6000)
    owners, buckets = fleet.router.route_batch(hist)
    for i, rep in enumerate(reps):
        idx = np.nonzero(owners == i)[0][:dep["store_capacity"]]
        rep.commit_execution(cell.traffic["service"], hist[idx],
                             [rep.name_of(cell.traffic["service"], b) for b in buckets[idx]],
                             [int(k) for k in idx], 0.0, 0.0, buckets=buckets[idx])
    ref = Fleet(dep, 20000)
    ref.fill(hist, owners, buckets, list(range(len(hist))))
    assert ref.n_wrong == 0
    x = tr.rounds(8)
    kinds = set()
    for r in range(8):
        ids = [r * 160 + k for k in range(160)]
        got = fleet.submit_batch_sync([ServeRequest(t, cell.traffic["service"], x[r, k])
                                       for k, t in enumerate(ids)])
        want, _ = ref.decide_round(x[r], ids, lambda t: [(i, 0) for i in t])
        assert [(g.replica, g.reuse, g.result) for g in got] == [
            (w.replica, w.kind, w.result) for w in want]
        kinds |= {g.reuse for g in got}
    assert kinds == ({"cs", "en", None} if mix == "cctv" else {None})


@pytest.mark.parametrize("arch_name", ["qwen3-1.7b", "qwen2.5-14b"])
def test_reference_logits_match_the_ports_reduced_model(arch_name):
    from repro_torch.convert import load_params
    from repro_torch.models import build_model
    cell, arch = tiny_cell(arch_name=arch_name)
    m = cell.config
    model = build_model(arch, "cpu")
    load_params(model, Weights(m, 5, "cpu"))
    tokens = torch.randint(m["vocab_size"], (6, 16), generator=torch.Generator().manual_seed(0))
    got, _ = model.prefill({"tokens": tokens.to(torch.int32)}, 24)
    want = dense_lm.last_logits(Weights(m, 5, "cpu"), m, tokens, block=4)
    scale = want.std(dim=-1, keepdim=True)
    assert ((got[:, -1] - want).abs() / scale).max() < 1e-4
    fp8 = dense_lm.last_logits(Weights(m, 5, "cpu"), m, tokens, matmul=dense_lm.fp8_matmul)
    assert ((fp8 - want).abs() / scale).max() > 1e-2
