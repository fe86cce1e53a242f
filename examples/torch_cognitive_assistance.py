"""Cognitive-assistance use case (paper §III) on the PyTorch/CUDA port:
visual search at the edge.

Twin of ``examples/cognitive_assistance.py`` on ``repro_torch``, with the
same flow, seeds and printout.  Tourists photograph landmarks from
different angles; an object-identification service runs at the edge.  A
ReuseRouter (rFIB semantics) steers similar requests to the same replica,
whose semantic cache answers near-duplicates without running the model,
and an elastic event (replica loss) re-partitions the bucket ranges live.
The model (a reduced phi-3-vision) and the reuse decision run on
``--device`` (default the CUDA card; without one it raises, so pass
``--device cpu``).

Run:  PYTHONPATH=src python examples/torch_cognitive_assistance.py [--device cpu]
"""
import argparse
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import load_params
from repro_torch.core.lsh import LSHParams
from repro_torch.data import DATASETS, make_stream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.serving import ReplicaEngine, ServeRequest, ServingFleet

LOST = "  !! replica 2 lost; re-partitioning bucket ranges"


def run(device: DeviceLike = None, n: int = 150,
        params: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """Serve ``n`` requests (the replica is lost after request 99); returns
    what ``main`` prints: the events, ``fleet.stats()``, the executions per
    replica and the wall seconds.  ``params``: the model's weights by the
    port's parameter names (for instance the reference's init through
    ``repro_torch.convert.model_from_jax``); default the port's seed 0.

    A miss group's execution takes its wall time on the fleet's virtual
    clock, as in the reference, so the hits by kind and the backups (and
    with them the executions per replica) can change from run to run with
    the host's speed."""
    dev = resolve_device(device)
    spec = DATASETS["stanford_ar"]  # object views: moderate correlation
    cfg = get_arch("phi-3-vision-4.2b").reduced()  # VLM family backbone
    model = build_model(cfg, dev, seed=0)
    if params is not None:
        load_params(model, params)
    seq = 24

    @torch.no_grad()
    def prefill(batch):
        logits, _ = model.prefill(batch, seq + cfg.n_frontend_tokens + 8)
        return logits

    def execute(reqs):
        out = []
        for r in reqs:
            out.append(int(torch.argmax(prefill(r.payload)[0, -1])))
        return out

    lshp = LSHParams(dim=spec.dim, num_tables=5, num_probes=8)
    replicas = [ReplicaEngine(i, lshp, execute, device=dev) for i in range(3)]
    fleet = ServingFleet(lshp, replicas, device=dev)

    X, labels = make_stream(spec, n, seed=4)
    rng = np.random.default_rng(0)
    events: List[str] = []
    t0 = time.time()
    for i, emb in enumerate(X):
        tokens = torch.from_numpy(((np.abs(emb[:seq]) * 1e4).astype(np.int64)
                                   % cfg.vocab_size).astype(np.int32))[None, :]
        patches = torch.from_numpy(rng.standard_normal(
            (1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)) * 0.02
        fleet.submit(ServeRequest(
            i, "identify-sight", emb,
            payload={"tokens": tokens.to(dev), "patch_embeds": patches.to(dev)},
            threshold=0.88))
        if i == 99:
            # elastic event: replica 2 fails -> consistent range re-split
            events.append(LOST)
            fleet.router.rescale(2)
    wall = time.time() - t0
    return {"n": n, "events": events, "stats": fleet.stats(), "wall": wall,
            "per_replica": [(r.replica_id, r.stats["executed"]) for r in replicas]}


def report(res: Dict[str, Any]) -> List[str]:
    """The reference's printed lines for a run."""
    s = res["stats"]
    total = sum(s[k] for k in ("cs", "en", "executed"))
    per_replica = [f"r{rid}:{n}" for rid, n in res["per_replica"]]
    return res["events"] + [
        f"\n{res['n']} requests in {res['wall']:.1f}s across 3->2 replicas",
        f"  answered from CS (exact LSH name):   {s['cs']:4d} "
        f"({100 * s['cs'] / total:.0f}%)",
        f"  answered by similarity reuse at EN:  {s['en']:4d} "
        f"({100 * s['en'] / total:.0f}%)",
        f"  executed the VLM from scratch:       {s['executed']:4d} "
        f"({100 * s['executed'] / total:.0f}%)",
        f"  executions per replica: {', '.join(per_replica)}"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the reuse decision "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    for line in report(run(args.device)):
        print(line)


if __name__ == "__main__":
    main()
