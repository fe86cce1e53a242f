"""The yardstick's arithmetic pinned to PERF.md §6's bound column and to the
published per-token costs."""
import json

import pytest

from bench import roofline
from bench.spec import ROOT


def test_k6_bound_matches_perf_md():
    # K6 at B=4, S=2048, H=16, KV=8, D=128, causal, bf16: 0.06952 ms (operations)
    assert roofline.k6_bound_s(4, 2048, 16, 8, 128) * 1e3 == pytest.approx(0.06952, abs=5e-6)


def test_k1_bound_matches_perf_md():
    # the serve store's B=1024, T=5, P=8, cap 512 at capacity: 0.03378 ms, bound by its
    # operations: 2·D FLOP for each of its 17.68M distinct (query, candidate) pairs
    # at the fp32 peak; the bytes (q, probes, 640 slot rows, 100k store rows) are below
    t = roofline.k1_bound_s(1024, 64, 5, 8, n_pairs=17_681_719, n_slot_rows=640, cap=512,
                            n_rows=100_000)
    assert t * 1e3 == pytest.approx(0.03378, abs=5e-6)
    t_bytes, by = roofline.bound_s(4 * 1024 * 64 + 4 * 1024 * 40 + 4 * 640 * 512
                                   + 4 * 100_000 * 64 + 8 * 1024, 0.0, 1.0)
    assert by == "bytes" and t_bytes < t


def test_bounds_are_exact_counts():
    # one sequence of 1: one visible pair, 4·D FLOP a head; q, k, v, out bytes
    assert roofline.causal_pairs(1) == 1 and roofline.causal_pairs(4) == 10
    t, by = roofline.bound_s(3.35e12, 0.0, 1.0)
    assert (t, by) == (1.0, "bytes")


@pytest.mark.parametrize("name,lo,hi", [("qwen3-1.7b", 2.80e9, 2.95e9),
                                        ("qwen2.5-14b", 26.3e9, 27.5e9)])
def test_prefill_flops_per_token(name, lo, hi):
    m = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    per_token = roofline.prefill_flop(m, 1, 256) / 256
    assert lo < per_token < hi
    # n prompts cost n times one
    assert roofline.prefill_flop(m, 96, 256) == pytest.approx(96 * roofline.prefill_flop(m, 1, 256))
