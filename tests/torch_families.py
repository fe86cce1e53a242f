"""Shared helpers of the model-family tests: one architecture's reduced
config in both packages (float32), the JAX ``init(PRNGKey(0))`` tree
converted into the port (``convert.model_from_jax``), seeded inputs, and
the 1e-4 comparison of tests/test_torch_models.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro_torch.configs import get_arch
from repro_torch.convert import cache_from_jax, model_from_jax

TOL = 1e-4


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def pair(arch: str, change: tuple = ()):
    """(jax cfg, jax model, jax params, port model) of ``arch``'s reduced
    config with ``change`` (a tuple of (field, value) pairs) applied."""
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), **dict(change))
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **dict(change))
    jm = j_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, params, model_from_jax(tcfg, tree_np(params), "cpu")


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def close_cache(got, want, tol=TOL):
    """Same keys, shapes and values (the port's cache dtype as asked)."""
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        close(got[name], want[name], tol)


def tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def batches(cfg, tok, seed=0, n_frames=8):
    """(jax batch, port batch) of ``tok`` plus the family's extra inputs:
    ``patch_embeds`` (vision) or ``frames`` (encoder-decoder), made from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    extra = {}
    if cfg.frontend == "vision":
        extra["patch_embeds"] = (rng.standard_normal(
            (tok.shape[0], cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.is_encdec:
        extra["frames"] = (rng.standard_normal(
            (tok.shape[0], n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok), **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(tok), **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb


def n_front(cfg) -> int:
    return cfg.n_frontend_tokens if cfg.frontend == "vision" else 0


def port_cache(cache):
    return cache_from_jax(tree_np(cache), "cpu")
