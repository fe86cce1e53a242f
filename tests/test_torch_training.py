"""The port's training path against the JAX package, on the CPU.

Both packages run ``get_arch("qwen3-1.7b").reduced()`` (float32, 2 layers,
d=64, head_dim 16) from the reference's ``init(PRNGKey(0))`` weights and
AdamW state, carried into the port by ``convert.train_state_from_jax``;
batches come from numpy seeds.  Tolerances are relative to the largest
magnitude (of a tensor, or of all parameters for the parameters after
training steps):

* ``DecoderLM.loss`` within 1e-5 (whole loss chunks, a remainder chunk,
  -1 labels); ``input_specs`` equal;
* every parameter's gradient within 1e-4 of ``jax.grad`` of the
  reference's loss (the port's attention gradient is K6's backward);
* ``make_train_step`` for 3 steps against the reference's jitted step:
  loss, grad norm and lr each step within 1e-5, every parameter after the
  third within 1e-5.  With ``compute_dtype="bfloat16"`` the gradients are
  bf16 values (8 bits), so the grad norm is held within 2^-8.  Int8
  moments round ``m / scale`` to an integer: where that lands on a tie
  (x.5 within float32 noise) the two packages may take the other side,
  one quantisation level apart, and Adam then divides by a second moment
  of 0 or of one level (``m / eps``), so those few elements differ
  widely, and the next step's gradients with them.  So with int8 moments
  each of the 3 steps starts both packages from the reference's state;
  the flipped elements are counted (at most 1e-3 of the moment elements,
  each one level off) and the parameters are held everywhere else.  So are
  the elements whose stored second moment is 0 while the first is not:
  their step is ``m / sqrt(0.05 g^2)``, the ratio to a gradient element at
  float noise, which moves them by up to thousands of ``lr``; every
  other parameter is held within 1e-5 of the larger of the largest
  parameter and its own change over the steps;
* ``_quantize`` bit-equal, ``lr_at`` equal at the schedule's knots;
* checkpoints: a reference checkpoint resumes on the port and stays in
  step with the reference's uninterrupted run; the reference's checkpoint
  tests on the port;
* ``launch/train.py``'s printed losses equal the reference's train loop's
  to the printed digits, and ``--ckpt-dir`` resumes.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtr
from repro.configs import ShapeSpec as JShape
from repro.configs import get_arch as j_get_arch
from repro.launch.train import synthetic_batch as j_synthetic_batch
from repro.models.transformer import DecoderLM as JDecoderLM
from repro.training.optimizer import _quantize as j_quantize
from repro_torch import training as ttr
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.convert import _family_leaves, _part, model_from_jax, train_state_from_jax
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import DecoderLM
from repro_torch.training import checkpoint as ck
from repro_torch.training.optimizer import _dequantize, _quantize

TOL = 1e-5
GRAD_TOL = 1e-4
ARCH = "qwen3-1.7b"
# the reference's TestTrainStep optimizer (warmup 100: lr 1e-5, 2e-5, 3e-5)
OPT = {"lr": 1e-3, "total_steps": 10}


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """(jax cfg, jax model, jax params, port cfg)."""
    jcfg, tcfg = j_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jm = JDecoderLM(jcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(0)), tcfg


def _batch(B, S, seed, pad=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 256, (B, S)).astype(np.int32)
    lab = rng.integers(0, 256, (B, S)).astype(np.int32)
    lab[0, :pad] = -1
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_state(ref_state, tcfg):
    return train_state_from_jax(tcfg, tree_np(ref_state), "cpu")


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("chunk,S,pad", [(64, 32, 0), (12, 30, 0), (8, 32, 11)],
                         ids=["one_chunk", "chunks_and_remainder", "pad_labels"])
def test_loss_matches_reference(ref, chunk, S, pad):
    jcfg, _, params, tcfg = ref
    jm = JDecoderLM(dataclasses.replace(jcfg, loss_chunk=chunk))
    model = model_from_jax(dataclasses.replace(tcfg, loss_chunk=chunk), tree_np(params), "cpu",
                           trainable=True)
    jb, tb = _batch(2, S, seed=chunk, pad=pad)
    jl, jmet = jm.loss(params, jb)
    tl, tmet = model.loss(tb)
    assert _rel(tl, jl) <= TOL
    assert sorted(tmet) == sorted(jmet) == ["aux", "nll", "tokens"]
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= TOL * max(abs(float(jmet[k])), 1.0)
    assert float(tmet["tokens"]) == 2 * S - pad


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(arch, kind):
    jcfg, tcfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    want = JDecoderLM(jcfg).input_specs(JShape("t", 40, 3, kind))
    got = DecoderLM(tcfg, "cpu").input_specs(ShapeSpec("t", 40, 3, kind))
    assert list(got) == list(want)
    for name, spec in want.items():
        shape, dtype = got[name]
        assert shape == spec.shape
        assert str(dtype).removeprefix("torch.") == str(spec.dtype)


def test_synthetic_batch_is_the_reference_stream(ref):
    jcfg, jm, _, tcfg = ref
    for step in (0, 7):
        want = j_synthetic_batch(jm, jcfg, JShape("cli", 32, 4, "train"), step)
        got = synthetic_batch(DecoderLM(tcfg, "cpu"), tcfg, ShapeSpec("cli", 32, 4, "train"),
                              step, "cpu")
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_gradients_match_jax_grad(ref):
    jcfg, jm, params, tcfg = ref
    jm = JDecoderLM(dataclasses.replace(jcfg, loss_chunk=12))
    model, _ = train_state_from_jax(dataclasses.replace(tcfg, loss_chunk=12),
                                    {"params": tree_np(params), "opt": {"step": np.int32(0)}},
                                    "cpu")
    jb, tb = _batch(3, 30, seed=5, pad=7)
    want = jax.grad(lambda p: jm.loss(p, jb)[0])(params)
    model.loss(tb)[0].backward()
    want = dict(_family_leaves(model, tree_np(want)))
    own = dict(model.named_parameters())
    assert sorted(want) == sorted(own)
    for name, w in want.items():
        assert own[name].grad is not None and bool(own[name].grad.any()), name
        assert _rel(own[name].grad, w) <= GRAD_TOL, name


# ------------------------------------------------------------ the train step
STEP_CASES = {
    "float32": ({}, 1, None),
    "bfloat16_moments": ({"moment_dtype": "bfloat16"}, 1, None),
    "int8_moments": ({"moment_dtype": "int8"}, 1, None),
    "compress_grads": ({"compress_grads": True}, 1, None),
    "microbatches_4": ({}, 4, None),
    "compute_bfloat16": ({}, 1, "bfloat16"),
}


def _without_second_moment(ref_opt, model) -> dict:
    """Elements of the reference's int8 moments with q(v) = 0, q(m) != 0."""
    qm = dict(_family_leaves(model, _part(tree_np(ref_opt["m"]), "q")))
    qv = dict(_family_leaves(model, _part(tree_np(ref_opt["v"]), "q")))
    return {name: (qv[name] == 0) & (qm[name] != 0) for name in qm}


def _int8_flips(port_opt, ref_opt, model, flipped) -> int:
    """Int8 moments of both packages: scales within 1e-5, q equal but for
    single levels, marked in ``flipped``; -> how many."""
    n = 0
    for key in ("m", "v"):
        q = dict(_family_leaves(model, _part(tree_np(ref_opt[key]), "q")))
        scale = dict(_family_leaves(model, _part(tree_np(ref_opt[key]), "scale")))
        for name, mine in port_opt[key].items():
            dq = np.abs(mine["q"].numpy().astype(np.int32) - q[name].astype(np.int32))
            assert dq.max() <= 1, (key, name)
            assert _rel(mine["scale"], scale[name]) <= TOL, (key, name)
            flipped[name] = flipped.get(name, np.zeros(dq.shape, bool)) | (dq > 0)
            n += int((dq > 0).sum())
    return n


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_reference(ref, case):
    jcfg, jm, params, tcfg = ref
    extra, micro, cdt = STEP_CASES[case]
    jo, to = jtr.OptimizerConfig(**OPT, **extra), ttr.OptimizerConfig(**OPT, **extra)
    jstate = {"params": params, "opt": jtr.adamw_init(params, jo)}
    model, state = _port_state(jstate, tcfg)
    jstep = jax.jit(jtr.make_train_step(jm, jo, microbatches=micro, compute_dtype=cdt))
    step = ttr.make_train_step(model, to, microbatches=micro, compute_dtype=cdt)
    gnorm_tol = 2.0 ** -8 if cdt == "bfloat16" else TOL
    int8 = extra.get("moment_dtype") == "int8"
    flipped, flips = {}, 0
    for i in range(3):
        if int8 or i == 0:   # with int8, each step from the reference's state (see the top)
            before = dict(_family_leaves(model, tree_np(jstate["params"])))
            flipped = _without_second_moment(jstate["opt"], model) if int8 else {}
            if int8:
                _, state = _port_state(jstate, tcfg)
        jb, tb = _batch(4, 32, seed=10 + i, pad=5)
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, tb)
        assert sorted(met) == sorted(jmet)
        assert _rel(met["loss"], jmet["loss"]) <= TOL
        assert _rel(met["lr"], jmet["lr"]) <= TOL
        assert _rel(met["grad_norm"], jmet["grad_norm"]) <= gnorm_tol
        if int8:
            flips += _int8_flips(state["opt"], jstate["opt"], model, flipped)
    want = dict(_family_leaves(model, tree_np(jstate["params"])))
    top = max(np.abs(w).max() for w in want.values())
    n_moments = 2 * sum(w.size for w in want.values())
    assert flips <= 3e-3 * n_moments     # 1e-3 a step
    for name, w in want.items():
        bad = np.abs(state["params"][name].numpy() - w) > TOL * np.maximum(
            top, np.abs(w - before[name]))
        if name in flipped:
            bad &= ~flipped[name]
        assert not bad.any(), name
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


def test_quantize_bit_equal():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((6, 64)).astype(np.float32) * np.float32([[1], [1e-3], [50], [1],
                                                                         [1], [1]])
    # scale 1 exactly (max 127): x / scale are the halves themselves
    rows[3, :8] = [127, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -126.5]
    rows[3, 8:] = np.round(rows[3, 8:])
    rows[4] = 0.0                                    # scale clamped at 1e-12
    rows[5, :4] = [-127, 0.5, -1.5, 3.5]
    rows[5, 4:] = 0.25
    want = j_quantize(jnp.asarray(rows))
    got = _quantize(torch.from_numpy(rows))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert got["q"].dtype == torch.int8
    assert got["q"][3, :8].tolist() == [127, 0, 2, 2, 0, -2, 64, -126]   # half to even


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_knots(schedule):
    kw = {"lr": 3e-4, "warmup_steps": 10, "total_steps": 50, "schedule": schedule}
    jc, tc = jtr.OptimizerConfig(**kw), ttr.OptimizerConfig(**kw)
    for s in (0, 10, 50, 60):                         # start, end of warmup, end, past it
        assert float(ttr.lr_at(tc, s)) == float(jtr.lr_at(jc, jnp.int32(s)))
    # between the knots the two cosines may differ by an ulp of float32
    for s in (1, 5, 11, 30, 49):
        np.testing.assert_allclose(float(ttr.lr_at(tc, torch.tensor(s, dtype=torch.int32))),
                                   float(jtr.lr_at(jc, jnp.int32(s))), rtol=0,
                                   atol=2.0 ** -23 * kw["lr"])


# ----------------------------------------------- mirrors of tests/test_training.py
def _toy_params(key=0):
    rng = np.random.default_rng(key)
    return {"w": torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((16,)).astype(np.float32))}


def _toy_grads(params, x, y):
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = ((x @ p["w"] + p["b"] - y) ** 2).mean()
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


class TestOptimizer:
    def _train(self, cfg, steps=150):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
        y = x @ torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
        params = _toy_params()
        state = ttr.adamw_init(params, cfg)
        losses = []
        for _ in range(steps):
            loss, grads = _toy_grads(params, x, y)
            params, state, m = ttr.adamw_update(params, grads, state, cfg)
            losses.append(float(loss))
        return losses, m

    def test_adamw_converges(self):
        cfg = ttr.OptimizerConfig(lr=1e-1, weight_decay=0.0, warmup_steps=5, grad_clip=10.0,
                                  schedule="constant")
        losses, m = self._train(cfg)
        assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
        assert float(m["grad_norm"]) >= 0

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_quantized_moments_still_converge(self, dtype):
        cfg = ttr.OptimizerConfig(lr=1e-1, weight_decay=0.0, warmup_steps=5, grad_clip=10.0,
                                  schedule="constant", moment_dtype=dtype)
        losses, _ = self._train(cfg)
        assert losses[-1] < 0.2 * losses[0], losses[-1]

    def test_grad_compression_error_feedback(self):
        cfg = ttr.OptimizerConfig(lr=1e-1, weight_decay=0.0, warmup_steps=5, grad_clip=10.0,
                                  schedule="constant", compress_grads=True)
        losses, _ = self._train(cfg)
        assert losses[-1] < 0.2 * losses[0]

    def test_schedule_shapes(self):
        cfg = ttr.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100)
        assert float(ttr.lr_at(cfg, 0)) == 0.0
        assert abs(float(ttr.lr_at(cfg, 10)) - 1.0) < 1e-6
        assert float(ttr.lr_at(cfg, 100)) < 1e-3

    @pytest.mark.parametrize("seed", range(20))
    def test_quantize_roundtrip(self, seed):
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal((4, 64)).astype(np.float32))
        err = (_dequantize(_quantize(x)) - x).abs().max()
        assert float(err) <= float(x.abs().max()) / 127 + 1e-6


class TestTrainStep:
    def _setup(self, microbatches=1):
        cfg = get_arch(ARCH).reduced()
        model = DecoderLM(cfg, "cpu", trainable=True)
        ocfg = ttr.OptimizerConfig(**OPT)
        state = ttr.init_state(model, ocfg)
        step = ttr.make_train_step(model, ocfg, microbatches=microbatches)
        rng = np.random.default_rng(1)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, shp).astype(np.int32))
                 for k, (shp, _) in model.input_specs(ShapeSpec("t", 32, 4, "train")).items()}
        return state, step, batch

    def test_loss_decreases_on_repeated_batch(self):
        state, step, batch = self._setup()
        first = None
        for _ in range(8):
            state, metrics = step(state, batch)
            first = float(metrics["loss"]) if first is None else first
        assert float(metrics["loss"]) < first

    def test_microbatching_matches_full_batch(self):
        s1, step1, batch = self._setup(microbatches=1)
        s4, step4, _ = self._setup(microbatches=4)
        s1, _ = step1(s1, batch)
        s4, _ = step4(s4, batch)
        for name, p in s1["params"].items():
            np.testing.assert_allclose(p.numpy(), s4["params"][name].numpy(), rtol=2e-3,
                                       atol=2e-4)

    def test_eval_step_is_the_loss(self):
        state, _, batch = self._setup()
        cfg = get_arch(ARCH).reduced()
        model = DecoderLM(cfg, "cpu", seed=3, trainable=True)
        out = ttr.make_eval_step(model)(state["params"], batch)
        own = DecoderLM(cfg, "cpu", trainable=True)
        with torch.no_grad():
            loss, metrics = own.loss(batch)
        assert float(out["loss"]) == float(loss)
        assert float(out["tokens"]) == float(metrics["tokens"]) == 128


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                "nested": {"b": torch.ones((5,), dtype=torch.bfloat16) * 1.5},
                "q": {"q": torch.full((4, 4), -3, dtype=torch.int8),
                      "scale": torch.ones((4, 1))},
                "step": torch.tensor(7, dtype=torch.int32)}
        ck.save(tree, str(tmp_path), step=7)
        assert ck.latest_step(str(tmp_path)) == 7
        target = {"a": torch.zeros(3, 4), "nested": {"b": torch.zeros(5, dtype=torch.bfloat16)},
                  "q": {"q": torch.zeros((4, 4), dtype=torch.int8), "scale": torch.zeros(4, 1)},
                  "step": torch.tensor(0, dtype=torch.int32)}
        out = ck.restore(str(tmp_path), target)
        assert out is target
        for (n, a), (_, b) in zip(ck._flatten(tree), ck._flatten(out)):
            assert a.dtype == b.dtype and torch.equal(a, b), n

    def test_manifest_is_the_references(self, tmp_path):
        tree = {"b": {"w": torch.ones(3, 2)}, "a": torch.zeros(4, dtype=torch.bfloat16)}
        path = ck.save(tree, str(tmp_path), step=2)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        assert [leaf["name"] for leaf in manifest["leaves"]] == ["a", "b/w"]
        assert [leaf["dtype"] for leaf in manifest["leaves"]] == ["bfloat16", "float32"]
        codec = "zlib" if ck.zstandard is None else "zst"
        assert manifest["shards"][0] == {"file": f"shard-000.bin.{codec}", "raw_bytes": 32,
                                         "codec": codec,
                                         "crc": manifest["shards"][0]["crc"]}
        # the reference reads it
        out = jtr.restore(str(tmp_path), jax.eval_shape(
            lambda: {"a": jnp.zeros(4, jnp.bfloat16), "b": {"w": jnp.zeros((3, 2))}}))
        assert str(out["a"].dtype) == "bfloat16"
        np.testing.assert_array_equal(np.asarray(out["b"]["w"]), np.ones((3, 2)))

    def test_corruption_detected(self, tmp_path):
        tree = {"a": torch.arange(1024, dtype=torch.float32)}
        path = ck.save(tree, str(tmp_path), step=1)
        with open(os.path.join(path, "manifest.json")) as f:
            shard = os.path.join(path, json.load(f)["shards"][0]["file"])
        with open(shard, "rb") as f:
            raw = f.read()
        with open(shard, "wb") as f:  # flip bytes in the compressed payload
            f.write(raw[:50] + bytes([raw[50] ^ 0xFF]) + raw[51:])
        with pytest.raises(Exception):
            ck.restore(str(tmp_path), {"a": torch.zeros(1024)})

    def test_zst_shard_without_zstandard_is_a_clear_error(self, tmp_path, monkeypatch):
        path = ck.save({"a": torch.zeros(4)}, str(tmp_path), step=1)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        manifest["shards"][0]["codec"] = "zst"
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        monkeypatch.setattr(ck, "zstandard", None)
        with pytest.raises(ImportError, match="zstandard"):
            ck.restore(str(tmp_path), {"a": torch.zeros(4)})

    def test_gc_keeps_newest(self, tmp_path):
        for s in (1, 2, 3, 4, 5):
            ck.save({"a": torch.zeros(4)}, str(tmp_path), step=s, keep=2)
        assert ck.latest_step(str(tmp_path)) == 5
        assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [4, 5]

    def test_async_checkpointer(self, tmp_path):
        tree = {"a": torch.full((128,), 3.0)}
        cp = ttr.AsyncCheckpointer()
        cp.save(tree, str(tmp_path), step=3)
        tree["a"].add_(1.0)      # an in-place step right after: the snapshot is a copy
        cp.wait()
        out = ck.restore(str(tmp_path), {"a": torch.zeros(128)})
        assert torch.equal(out["a"], torch.full((128,), 3.0))
        assert cp.last_path.endswith("step_00000003")

    def test_restart_resumes_training(self, tmp_path):
        cfg = ttr.OptimizerConfig(lr=1e-2, total_steps=20)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
        params = _toy_params()
        state = {"params": params, "opt": ttr.adamw_init(params, cfg)}
        for _ in range(3):
            _, grads = _toy_grads(state["params"], x, y)
            ttr.adamw_update(state["params"], grads, state["opt"], cfg)
        ck.save(state, str(tmp_path), step=3)
        fresh = _toy_params(1)
        restored, step = ck.resume_or_init(
            str(tmp_path), lambda: {"params": fresh, "opt": ttr.adamw_init(fresh, cfg)})
        assert step == 3 and int(restored["opt"]["step"]) == 3
        assert torch.equal(restored["params"]["w"], state["params"]["w"])
        _, grads = _toy_grads(restored["params"], x, y)
        p2, _, _ = ttr.adamw_update(restored["params"], grads, restored["opt"], cfg)
        assert torch.isfinite(p2["w"]).all()

    def test_bf16_moment_state_round_trip(self, tmp_path):
        cfg = get_arch(ARCH).reduced()
        ocfg = ttr.OptimizerConfig(**OPT, moment_dtype="bfloat16")
        model = DecoderLM(cfg, "cpu", trainable=True)
        state = ttr.init_state(model, ocfg)
        step = ttr.make_train_step(model, ocfg)
        _, tb = _batch(4, 32, seed=3)
        for _ in range(2):
            state, _ = step(state, tb)
        ck.save(state, str(tmp_path), step=2)
        other = DecoderLM(cfg, "cpu", seed=9, trainable=True)
        fresh = ck.restore(str(tmp_path), ttr.init_state(other, ocfg))
        for (n, a), (_, b) in zip(ck._flatten(state), ck._flatten(fresh)):
            assert a.dtype == b.dtype and torch.equal(a, b), n
        assert fresh["opt"]["m"]["embed"].dtype == torch.bfloat16
        # the restored state trains on as the original does
        s1, m1 = ttr.make_train_step(model, ocfg)(state, tb)
        s2, m2 = ttr.make_train_step(other, ocfg)(fresh, tb)
        assert float(m1["loss"]) == float(m2["loss"])


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_resumes_on_the_port(ref, tmp_path, moments):
    """The reference trains 2 steps and saves; the port reads that
    checkpoint, carries it across and trains 2 more, in step with the
    reference's uninterrupted 4."""
    jcfg, jm, params, tcfg = ref
    jo = jtr.OptimizerConfig(**OPT, moment_dtype=moments)
    jstate = {"params": params, "opt": jtr.adamw_init(params, jo)}
    jstep = jax.jit(jtr.make_train_step(jm, jo))
    batches = [_batch(4, 32, seed=20 + i, pad=3) for i in range(4)]
    for jb, _ in batches[:2]:
        jstate, _ = jstep(jstate, jb)
    jtr.save(jstate, str(tmp_path), step=2)
    tree = ck.read(str(tmp_path))
    assert tree["opt"]["m"]["embed"].dtype == (torch.bfloat16 if moments == "bfloat16"
                                               else torch.float32)
    model, state = train_state_from_jax(tcfg, tree, "cpu")
    assert int(state["opt"]["step"]) == 2
    step = ttr.make_train_step(model, ttr.OptimizerConfig(**OPT, moment_dtype=moments))
    for jb, tb in batches[2:]:
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, tb)
        assert _rel(met["loss"], jmet["loss"]) <= TOL
        assert _rel(met["grad_norm"], jmet["grad_norm"]) <= TOL
    want = dict(_family_leaves(model, tree_np(jstate["params"])))
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        assert np.abs(state["params"][name].numpy() - w).max() <= TOL * top, name


def test_train_state_from_jax_is_strict(ref):
    _, _, params, tcfg = ref
    jo = jtr.OptimizerConfig(**OPT)
    state = tree_np({"params": params, "opt": jtr.adamw_init(params, jo)})
    del state["opt"]["m"]["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        train_state_from_jax(tcfg, state, "cpu")
    state = tree_np({"params": params, "opt": jtr.adamw_init(params, jo)})
    state["opt"]["v"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        train_state_from_jax(tcfg, state, "cpu")


# ------------------------------------------------------------ the launcher
def _step_lines(text):
    """{step: (loss, gnorm)} as printed."""
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if parts[:1] == ["step"]:
            out[int(parts[1])] = (parts[3], parts[5])
    return out


def test_train_launcher_matches_reference(ref, tmp_path, capsys):
    """The reference's ``main`` cannot run on this JAX (0.9 refuses its
    ``with_sharding_constraint`` on a mesh of Explicit axes), so its loop is
    run here as ``main`` runs it without the mesh: the same config, step
    function, batches and line format.  The port starts from the
    reference's weights through a step-0 checkpoint in ``--ckpt-dir``."""
    jcfg, jm, params, tcfg = ref
    steps, shape = 6, JShape("cli", 32, 4, "train")
    jo = jtr.OptimizerConfig(lr=3e-4, total_steps=steps)
    jstate = {"params": params, "opt": jtr.adamw_init(params, jo)}
    _, state0 = train_state_from_jax(tcfg, tree_np(jstate), "cpu")
    ck.save(state0, str(tmp_path), step=0)
    jstep = jax.jit(jtr.make_train_step(jm, jo))
    want = {}
    for s in range(steps):
        jstate, m = jstep(jstate, j_synthetic_batch(jm, jcfg, shape, s))
        want[s + 1] = (f"{float(m['loss']):.4f}", f"{float(m['grad_norm']):.3f}")
    argv = ["--arch", ARCH, "--reduced", "--steps", str(steps), "--seq-len", "32", "--batch",
            "4", "--log-every", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    capsys.readouterr()
    history = train_main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 0" in out
    assert _step_lines(out) == want
    assert [h["step"] for h in history] == list(range(1, steps + 1))
    assert ck.latest_step(str(tmp_path)) == steps
    # a crash after step 3's checkpoint: the rerun resumes there
    shutil.rmtree(tmp_path / f"step_{steps:08d}")
    train_main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert _step_lines(out) == {s: want[s] for s in range(4, steps + 1)}
