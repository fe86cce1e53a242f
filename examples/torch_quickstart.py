"""Quickstart on the PyTorch/CUDA port: the Reservoir computation-reuse
pipeline in 60 lines.

Twin of ``examples/quickstart.py`` on ``repro_torch``: the same two-EN edge
network (the paper's Fig. 7 testbed), traffic-monitoring service, stream of
correlated CCTV-like tasks, seeds and printout.  The reuse decision (the
clients' LSH hash and every EN reuse store) runs on ``--device`` (default
the CUDA card; without one it raises, so pass ``--device cpu``).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
from typing import Dict, List

import numpy as np

from repro_torch.core.lsh import LSHParams
from repro_torch.core.network import ReservoirNetwork
from repro_torch.core.topology import testbed_topology
from repro_torch.data import DATASETS, dataset_service, make_stream
from repro_torch.device import DeviceLike, resolve_device


def run(device: DeviceLike = None) -> Dict[str, float]:
    """The network run; returns ``net.metrics.summary()``."""
    dev = resolve_device(device)
    spec = DATASETS["cctv1"]  # high-correlation video stream, coarse service
    params = LSHParams(dim=spec.dim, num_tables=5, num_probes=8)

    graph, edge_nodes = testbed_topology()
    net = ReservoirNetwork(graph, edge_nodes, params, seed=0, device=dev)
    net.register_service(dataset_service(spec))
    net.add_user("camera-1", "fwd1")
    net.add_user("camera-2", "fwd1")

    X, _ = make_stream(spec, 200, seed=1)
    t = 0.0
    for i, snapshot in enumerate(X):
        net.submit_task(f"camera-{i % 2 + 1}", spec.name, snapshot,
                        threshold=0.9, at_time=t)
        t += 0.05  # 20 snapshots/sec across cameras
    net.run()
    return net.metrics.summary()


def report(s: Dict[str, float]) -> List[str]:
    """The reference's printed lines for a summary."""
    lines = [
        f"tasks completed:        {int(s['tasks'])}",
        f"reused from network CS: {s['reuse_pct_cs']:.1f}%  "
        f"(mean completion {s['mean_ct_cs'] * 1e3:.2f} ms)",
        f"reused at edge nodes:   {s['reuse_pct_en']:.1f}%  "
        f"(mean completion {s['mean_ct_en'] * 1e3:.2f} ms)",
        f"executed from scratch:  {100 - s['reuse_pct']:.1f}%  "
        f"(mean completion {s['mean_ct_scratch'] * 1e3:.2f} ms)",
        f"reuse accuracy:         {s['accuracy_pct']:.1f}%"]
    if s["mean_ct_cs"] > 0:
        lines.append(f"CS-reuse speedup:       "
                     f"{s['mean_ct_scratch'] / s['mean_ct_cs']:.1f}x "
                     f"(paper: 12.02-21.34x)")
    lines.append(f"EN-reuse speedup:       "
                 f"{s['mean_ct_scratch'] / s['mean_ct_en']:.1f}x (paper: 5.25-6.22x)")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the reuse decision (default: the CUDA card)")
    args = ap.parse_args(argv)
    for line in report(run(args.device)):
        print(line)


if __name__ == "__main__":
    main()
