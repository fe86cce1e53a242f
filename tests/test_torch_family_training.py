"""Training of every other model family: the port against the JAX package, on the CPU.

Nine architectures, each at its reduced config in float32
(``torch_families.pair``: the reference's ``init(PRNGKey(0))`` weights
carried into the port's training construction by
``convert.model_from_jax(..., trainable=True)``): zamba2 (Mamba2 hybrid),
xlstm, seamless (encoder-decoder), qwen2-moe and llama4 (MoE, llama4 with
patch embeddings), phi-3-vision (patch positions labelled -1), and the dense
gemma-2b (MQA, GeGLU, scaled and tied embeddings), gemma2-9b (local and
global layers, a sliding window, attention and final softcaps, post-norms,
``query_pre_attn_scalar``) and qwen2.5-14b (QKV bias); gemma-2b once more
at its published head width 256, so that the backward at D=256 is held too.
Batches come from numpy seeds.  Tolerances are relative to
the largest magnitude, as in tests/test_torch_training.py:

* ``loss`` and its metrics within 1e-5.  The hybrid and the encoder-decoder
  drop the remainder chunk, as their references do: a case with S not a
  multiple of ``loss_chunk`` counts only the whole chunks' tokens;
* every parameter's gradient within 1e-4 of ``jax.grad`` of the reference's
  loss (attention's through K6's backward; MoE routing, the sort-based
  dispatch and the Switch aux term; the shared block's gradient summed over
  its applications; the sLSTM time loop);
* ``input_specs`` for train, prefill and decode, and ``synthetic_batch``
  drawing the reference's stream bit for bit;
* ``make_train_step`` for 3 steps against the reference's jitted step: loss,
  grad norm and lr each step within 1e-5, every parameter after the third
  within 1e-5 of the larger of the largest parameter and its own change;
* a reference train state (masters, and m/v in float32, bfloat16 or int8)
  carried across by ``train_state_from_jax``, leaf for leaf, and a
  reference checkpoint resumed on the port in step with the reference;
* ``launch/train.py``'s ``main`` with ``--reduced`` for every architecture,
  and its printed step lines against the reference's loop for the hybrid
  and the encoder-decoder.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro import training as jtr
from repro.configs import ShapeSpec as JShape
from repro.launch.train import synthetic_batch as j_synthetic_batch
from repro.training.optimizer import _quantize as j_quantize
from repro_torch import training as ttr
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import _family_leaves, model_from_jax, train_state_from_jax
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ck

TOL = 1e-5
GRAD_TOL = 1e-4
FAMILIES = ("zamba2-7b", "xlstm-125m", "seamless-m4t-large-v2", "qwen2-moe-a2.7b",
            "llama4-maverick-400b-a17b", "phi-3-vision-4.2b", "gemma-2b", "gemma2-9b",
            "qwen2.5-14b")
REMAINDER_DROPPED = ("zamba2-7b", "seamless-m4t-large-v2")   # hybrid, encoder-decoder
# the reference's TestTrainStep optimizer (warmup 100: lr 1e-5, 2e-5, 3e-5)
OPT = {"lr": 1e-3, "total_steps": 10}


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ref(arch: str, loss_chunk: int = 0, change: tuple = ()):
    """(jax cfg, jax model, jax params, port cfg), ``loss_chunk`` and the
    fields of ``change`` ((field, value) pairs) changed if given."""
    change = change + ((("loss_chunk", loss_chunk),) if loss_chunk else ())
    jcfg, jm, params, _ = fam.pair(arch, change)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **dict(change))
    return jcfg, jm, params, tcfg


def _trainable(tcfg, params):
    return model_from_jax(tcfg, fam.tree_np(params), "cpu", trainable=True)


def _batch(cfg, B: int, S: int, seed: int, pad: int = 0):
    """(jax batch, port batch): S tokens and their labels (-1 on the first
    ``pad`` of row 0), with the family's patch embeddings or S // 2 + 1
    frames."""
    tok = fam.tokens(B, S, cfg.vocab_size, seed)
    lab = fam.tokens(B, S, cfg.vocab_size, seed + 1000)
    lab[0, :pad] = -1
    jb, tb = fam.batches(cfg, tok, seed, n_frames=S // 2 + 1)
    jb["labels"], tb["labels"] = jnp.asarray(lab), torch.from_numpy(lab)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jstep(arch: str):
    """The reference's jitted train step of ``arch`` (float32 moments), one
    compile shared by the tests."""
    _, jm, _, _ = _ref(arch)
    return jax.jit(jtr.make_train_step(jm, jtr.OptimizerConfig(**OPT)))


# ---------------------------------------------------------------- the model
LOSS_CASES = [(a, 0, 32, 0) for a in FAMILIES] + [(a, 0, 32, 9) for a in FAMILIES] + [
    (a, 12, 30, 5) for a in REMAINDER_DROPPED]


@pytest.mark.parametrize("arch,chunk,S,pad", LOSS_CASES,
                         ids=[f"{a}-chunk{c}-S{s}-pad{p}" for a, c, s, p in LOSS_CASES])
def test_loss_matches_reference(arch, chunk, S, pad):
    jcfg, jm, params, tcfg = _ref(arch, chunk)
    model = _trainable(tcfg, params)
    jb, tb = _batch(tcfg, 2, S, seed=S + pad, pad=pad)
    jl, jmet = jm.loss(params, jb)
    with torch.no_grad():
        tl, tmet = model.loss(tb)
    assert _rel(tl, jl) <= TOL
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= TOL * max(abs(float(jmet[k])), 1.0), k
    counted = 2 * S - pad
    if arch in REMAINDER_DROPPED and chunk:
        counted = 2 * (S // chunk * chunk) - pad     # the remainder chunk counts for nothing
    assert float(tmet["tokens"]) == counted


def _gradients_match(arch: str, change: tuple = ()) -> None:
    jcfg, jm, params, tcfg = _ref(arch, change=change)
    model = _trainable(tcfg, params)
    jb, tb = _batch(tcfg, 3, 32, seed=5, pad=7)
    want = jax.grad(lambda p: jm.loss(p, jb)[0])(params)
    model.loss(tb)[0].backward()
    want = dict(_family_leaves(model, fam.tree_np(want)))
    own = dict(model.named_parameters())
    assert sorted(want) == sorted(own)
    for name, w in want.items():
        assert own[name].grad is not None and bool(own[name].grad.any()), name
        assert _rel(own[name].grad, w) <= GRAD_TOL, name


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match_jax_grad(arch):
    _gradients_match(arch)


def test_gradients_match_jax_grad_at_head_width_256():
    """gemma-2b's reduced config at its published head width (4 heads of
    256, MQA): attention's gradient through the plain D=256 backward."""
    _gradients_match("gemma-2b", (("head_dim", 256),))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(arch, kind):
    jcfg, jm, _, tcfg = _ref(arch)
    want = jm.input_specs(JShape("t", 40, 3, kind))
    got = build_model(tcfg, "cpu").input_specs(ShapeSpec("t", 40, 3, kind))
    assert list(got) == list(want)
    for name, spec in want.items():
        shape, dtype = got[name]
        assert shape == spec.shape
        assert str(dtype).removeprefix("torch.") == str(spec.dtype)


@pytest.mark.parametrize("arch", FAMILIES)
def test_synthetic_batch_is_the_reference_stream(arch):
    jcfg, jm, _, tcfg = _ref(arch)
    model = build_model(tcfg, "cpu")
    for step in (0, 7):
        want = j_synthetic_batch(jm, jcfg, JShape("cli", 32, 4, "train"), step)
        got = synthetic_batch(model, tcfg, ShapeSpec("cli", 32, 4, "train"), step, "cpu")
        assert list(got) == list(want)
        for k in want:
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------ the train step
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch):
    jcfg, jm, params, tcfg = _ref(arch)
    jstate = {"params": params, "opt": jtr.adamw_init(params, jtr.OptimizerConfig(**OPT))}
    model, state = train_state_from_jax(tcfg, fam.tree_np(jstate), "cpu")
    step = ttr.make_train_step(model, ttr.OptimizerConfig(**OPT))
    before = dict(_family_leaves(model, fam.tree_np(params)))
    for i in range(3):
        jb, tb = _batch(tcfg, 4, 32, seed=10 + i, pad=5)
        jstate, jmet = _jstep(arch)(jstate, jb)
        state, met = step(state, tb)
        assert sorted(met) == sorted(jmet)
        for key in ("loss", "lr", "grad_norm"):
            assert _rel(met[key], jmet[key]) <= TOL, (i, key)
    want = dict(_family_leaves(model, fam.tree_np(jstate["params"])))
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        lim = TOL * np.maximum(top, np.abs(w - before[name]))
        assert not (np.abs(state["params"][name].numpy() - w) > lim).any(), name
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


def _random_moments(params, dtype: str, seed: int):
    """A moment tree shaped like ``params``, in the reference's storage for
    ``dtype`` (int8: its own ``_quantize``)."""
    rng = np.random.default_rng(seed)

    def one(p):
        x = jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 1e-3)
        if dtype == "int8":
            return j_quantize(x)
        return x.astype(jnp.dtype(dtype))

    return jax.tree.map(one, params)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_reference_train_state_converts(arch, moments):
    """Masters, m and v (and the step) of a reference train state land on the
    port's parameters leaf for leaf, bit for bit; a missing leaf fails."""
    _, _, params, tcfg = _ref(arch)
    state_np = fam.tree_np({"params": params, "opt": {
        "step": jnp.int32(4), "m": _random_moments(params, moments, 1),
        "v": _random_moments(params, moments, 2)}})
    model, state = train_state_from_jax(tcfg, state_np, "cpu")
    assert int(state["opt"]["step"]) == 4
    own = dict(model.named_parameters())
    for name, w in _family_leaves(model, state_np["params"]):
        assert state["params"][name].data_ptr() == own[name].data_ptr()   # the masters
        np.testing.assert_array_equal(state["params"][name].numpy(), w)
    for key in ("m", "v"):
        parts = ("q", "scale") if moments == "int8" else (None,)
        for part in parts:
            tree = state_np["opt"][key]
            if part:
                tree = jax.tree.map(lambda d: d[part], tree,
                                    is_leaf=lambda x: isinstance(x, dict) and "q" in x)
            for name, w in _family_leaves(model, tree):
                got = state["opt"][key][name]
                got = got[part] if part else got
                assert str(got.dtype).removeprefix("torch.") == str(w.dtype), (key, name)
                np.testing.assert_array_equal(got.float().numpy(), w.astype(np.float32))
    del state_np["opt"]["v"]["final_norm" if "final_norm" in params else "dec_norm"]
    with pytest.raises(ValueError, match="_norm"):
        train_state_from_jax(tcfg, state_np, "cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_reference_checkpoint_resumes_on_the_port(arch, tmp_path):
    """The reference trains 2 steps and saves; the port reads that
    checkpoint, carries it across and trains 1 more, in step with the
    reference's third."""
    jcfg, jm, params, tcfg = _ref(arch)
    jstate = {"params": params, "opt": jtr.adamw_init(params, jtr.OptimizerConfig(**OPT))}
    batches = [_batch(tcfg, 4, 32, seed=20 + i, pad=3) for i in range(3)]
    for jb, _ in batches[:2]:
        jstate, _ = _jstep(arch)(jstate, jb)
    jtr.save(jstate, str(tmp_path), step=2)
    model, state = train_state_from_jax(tcfg, ck.read(str(tmp_path)), "cpu")
    assert int(state["opt"]["step"]) == 2
    jb, tb = batches[2]
    jstate, jmet = _jstep(arch)(jstate, jb)
    state, met = ttr.make_train_step(model, ttr.OptimizerConfig(**OPT))(state, tb)
    assert _rel(met["loss"], jmet["loss"]) <= TOL
    assert _rel(met["grad_norm"], jmet["grad_norm"]) <= TOL
    want = dict(_family_leaves(model, fam.tree_np(jstate["params"])))
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        assert np.abs(state["params"][name].numpy() - w).max() <= TOL * top, name


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_launcher_runs_every_arch(arch):
    history = train_main(["--arch", arch, "--reduced", "--steps", "2", "--seq-len", "32",
                          "--batch", "2", "--log-every", "1"], device="cpu")
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in history)


def _step_lines(text):
    """{step: (loss, gnorm)} as printed."""
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if parts[:1] == ["step"]:
            out[int(parts[1])] = (parts[3], parts[5])
    return out


@pytest.mark.parametrize("arch", REMAINDER_DROPPED)
def test_train_launcher_matches_reference(arch, tmp_path, capsys):
    """The reference's loop as its ``main`` runs it without the mesh (which
    fails on this JAX: tests/test_torch_training.py), against the port's
    ``main`` started from the reference's weights through a step-0
    checkpoint in ``--ckpt-dir``."""
    jcfg, jm, params, tcfg = _ref(arch)
    steps, shape = 4, JShape("cli", 32, 4, "train")
    jo = jtr.OptimizerConfig(lr=3e-4, total_steps=steps)
    jstate = {"params": params, "opt": jtr.adamw_init(params, jo)}
    _, state0 = train_state_from_jax(tcfg, fam.tree_np(jstate), "cpu")
    ck.save(state0, str(tmp_path), step=0)
    jstep = jax.jit(jtr.make_train_step(jm, jo))
    want = {}
    for s in range(steps):
        jstate, m = jstep(jstate, j_synthetic_batch(jm, jcfg, shape, s))
        want[s + 1] = (f"{float(m['loss']):.4f}", f"{float(m['grad_norm']):.3f}")
    capsys.readouterr()
    history = train_main(["--arch", arch, "--reduced", "--steps", str(steps), "--seq-len", "32",
                          "--batch", "4", "--log-every", "1", "--ckpt-dir", str(tmp_path)],
                         device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 0" in out
    assert _step_lines(out) == want
    assert [h["step"] for h in history] == list(range(1, steps + 1))
