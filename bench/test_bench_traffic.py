"""The traffic generator: deterministic by seed, the mix's structure, and the
seeded weights."""
import json

import numpy as np
import torch

from bench.spec import ROOT
from bench.traffic import Traffic, centers, prompts, sample_mask
from bench.weights import Weights, groups

CCTV = json.loads((ROOT / "bench/traffic/cctv.json").read_text())
FRESH = json.loads((ROOT / "bench/traffic/fresh.json").read_text())
BIG_SEED = 2 ** 31 + 12345


def test_same_seed_same_rows_other_seed_other_rows():
    a = Traffic(CCTV, BIG_SEED, 32, "cpu").rounds(20)
    b = Traffic(CCTV, BIG_SEED, 32, "cpu").rounds(20)
    c = Traffic(CCTV, BIG_SEED + 1, 32, "cpu").rounds(20)
    assert a.shape == (20, 32, 64) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, atol=1e-5)
    h = Traffic(CCTV, BIG_SEED, 32, "cpu").history(100)
    assert h.shape == (100, 64) and not np.array_equal(h[:32], a[0])
    assert np.array_equal(prompts(BIG_SEED, 8, 16, 1000, "cpu"), prompts(BIG_SEED, 8, 16, 1000, "cpu"))
    assert np.array_equal(sample_mask(BIG_SEED, 50, 0.5), sample_mask(BIG_SEED, 50, 0.5))


def test_cameras_drift_and_a_tenth_is_novel():
    x = Traffic(CCTV, 7, 200, "cpu").rounds(40)
    cos = (x[1:] * x[:-1]).sum(-1)                   # each camera's consecutive frames
    assert np.median(cos) > 0.99
    # novel rows lie near no sub-centre; camera rows near one
    subs = centers(CCTV["cameras"])
    near = (x.reshape(-1, 64) @ subs.T).max(axis=1)
    assert 0.05 < (near < 0.7).mean() < 0.15
    f = Traffic(FRESH, 7, 200, "cpu").rounds(5)
    assert (np.abs((f[1:] * f[:-1]).sum(-1)) < 0.7).all()


def test_centres_are_the_datasets():
    from repro_torch.data import DATASETS
    spec = DATASETS["cctv1"]
    cam = CCTV["cameras"]
    for k in ("dim", "n_classes", "subs_per_class", "sub_spread", "item_noise", "walk_noise",
              "run_length"):
        assert cam[k] == getattr(spec, k)
    assert cam["centers_seed"] == spec.seed
    np.testing.assert_allclose(centers(cam), spec.centers()[1], atol=1e-6)


def test_weights_are_seeded_groups_in_any_order():
    m = json.loads((ROOT / "bench/configs/qwen2.5-14b.json").read_text())
    m = dict(m, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=8, vocab_size=50,
             torch_dtype="float32")
    w1, w2 = Weights(m, BIG_SEED, "cpu"), Weights(m, BIG_SEED, "cpu")
    late = w2.by_group("layers.1")["attn.wq"].clone()
    assert torch.equal(w1["layers.1.attn.wq"], late)
    assert w1["layers.0.attn.bq"].abs().max() > 0 and w1["layers.0.ln1"].dtype == torch.float32
    names = [n for _, leaves in groups(m) for n, _, _ in leaves]
    assert sorted(names) == sorted(w1) and "head" in names
