"""The port's shardings (``repro_torch.launch.shardings``) against the
reference's on the production meshes, and every model's ``cache_specs``.

The reference runs here without devices: ``jax.sharding.AbstractMesh``
takes its ``state_shardings`` and ``cache_shardings``, and its train states
are ``jax.eval_shape`` trees.  The port's states are built on the meta
device at full config.  Leaves pair through ``convert._family_leaves`` (a
stacked reference leaf of (n_groups, ...) is the port's per-layer leaves),
and the reference's spec on the port leaf's trailing dims must be the
port's, as a spec and as DTensor placements: every architecture, mode
("tp", "fsdp", "ep" with experts over "data"), mesh (16 x 16 and 2 x 16 x
16) and moment dtype.  ``batch_shardings`` of ``input_specs`` and
``cache_shardings`` / ``cache_specs`` (keys, shapes and dtypes) equal the
reference's, and a reduced model's real cache from ``prefill`` has the
shapes and dtypes ``cache_specs`` gives.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ShapeSpec as JShape
from repro.launch import shardings as j_shl
from repro.models import build_model as j_build_model
from repro.training.optimizer import OptimizerConfig as JOpt
from repro.training.optimizer import adamw_init as j_adamw_init
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import shardings as shl
from repro_torch.models import build_model, use_mesh
from repro_torch.models.partitioning import AbstractMesh, placements
from repro_torch.training import OptimizerConfig, init_state

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("tp", "fsdp", "ep")
MOMENTS = ("float32", "bfloat16", "int8")


def _rules(mode):
    return {"experts": "data"} if mode == "ep" else None


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return build_model(get_arch(arch), "meta", trainable=True)


@functools.lru_cache(maxsize=None)
def _port_state(arch, moments):
    return init_state(_port_model(arch), OptimizerConfig(moment_dtype=moments))


@functools.lru_cache(maxsize=None)
def _ref_model(arch):
    return j_build_model(j_get_arch(arch))


@functools.lru_cache(maxsize=None)
def _ref_state(arch, moments):
    jm, opt = _ref_model(arch), JOpt(moment_dtype=moments)
    return jax.eval_shape(lambda k: {"params": jm.init(k), "opt": j_adamw_init(jm.init(k), opt)},
                          jax.random.PRNGKey(0))


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), jax.sharding.AbstractMesh(shape, axes)


class _Box:
    """A reference spec riding through ``convert``'s leaf pairing."""

    def __init__(self, spec):
        self.spec = tuple(spec)


def _stacked_dims(model, top: str) -> int:
    if isinstance(model, convert.DecoderLM):
        return 1 if top.startswith("layers_") else 0
    return convert._STACKED[type(model).__name__].get(top, 0)


def _ref_specs_by_port_name(model, shd_tree, shape_tree):
    """{port leaf name: the reference's spec on the port leaf's dims} of a
    params-like reference tree (an int8 moment's leaves get ``.q`` /
    ``.scale``)."""
    def boxed(top, shd, leaf):
        k = _stacked_dims(model, top)
        spec = tuple(shd.spec) + (None,) * (len(leaf.shape) - len(shd.spec))
        if k == 0:
            return _Box(spec)
        arr = np.empty(leaf.shape[:k], dtype=object)
        for idx in np.ndindex(*leaf.shape[:k]):
            arr[idx] = _Box(spec[k:])
        return arr

    tree = {top: jax.tree.map(functools.partial(boxed, top), shd_tree[top], shape_tree[top])
            for top in shd_tree}
    return {name: box.spec for name, box in convert._family_leaves(model, tree)}


def _port_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _port_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _norm(spec):
    """A spec with single-axis tuples as the axis name (as the two packages
    write them interchangeably)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)


@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_shardings_match_reference(arch, mode, mesh, moments):
    pmesh, jmesh = _meshes(mesh)
    model = _port_model(arch)
    cfg = get_arch(arch)
    ref_shapes = _ref_state(arch, moments)
    ref = j_shl.state_shardings(ref_shapes, jmesh, mode, cfg.family)
    want = {("params",): _ref_specs_by_port_name(model, ref["params"], ref_shapes["params"])}
    for key in ("m", "v"):
        want[("opt", key)] = _ref_specs_by_port_name(model, ref["opt"][key],
                                                     ref_shapes["opt"][key])
    state = _port_state(arch, moments)
    with use_mesh(pmesh, _rules(mode)):
        got = shl.state_shardings(state, pmesh, mode, cfg.family)
    n = 0
    for path, leaf in _port_leaves(state):
        if path == ("opt", "step"):
            assert tuple(ref["opt"]["step"].spec) == ()
            assert got["opt"]["step"] == placements((), pmesh)
            continue
        section = path[:1] if path[0] == "params" else path[:2]
        name = ".".join(path[len(section):])
        spec = _norm(want[section][name])
        assert _norm(shl.state_spec(path, leaf, pmesh, mode, cfg.family)) == spec, path
        node = got
        for key in path:
            node = node[key]
        assert node == placements(spec, pmesh), path
        n += 1
    assert n == sum(len(w) for w in want.values())   # every reference leaf was compared


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_batch_shardings_match_reference(arch, mesh):
    """``cache_specs`` (batch 8, length 4096): keys, shapes, dtypes; their
    ``cache_shardings``; ``batch_shardings`` of each kind's ``input_specs``."""
    pmesh, jmesh = _meshes(mesh)
    model, jm = _port_model(arch), _ref_model(arch)
    family = get_arch(arch).family
    got, want = model.cache_specs(8, 4096), jm.cache_specs(8, 4096)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k
    shd, jshd = shl.cache_shardings(got, pmesh, family), j_shl.cache_shardings(want, jmesh, family)
    for k in got:
        assert _norm(shl.cache_spec(k, got[k], pmesh, family)) == _norm(jshd[k].spec), k
        assert shd[k] == placements(tuple(jshd[k].spec), pmesh), k
    for kind, S in (("train", 4096), ("prefill", 4096), ("decode", 4096)):
        specs, jspecs = model.input_specs(ShapeSpec("s", S, 32, kind)), jm.input_specs(
            JShape("s", S, 32, kind))
        assert sorted(specs) == sorted(jspecs)
        bshd, jbshd = shl.batch_shardings(specs, pmesh), j_shl.batch_shardings(jspecs, jmesh)
        for k in specs:
            assert bshd[k] == placements(tuple(jbshd[k].spec), pmesh), (kind, k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_cache_has_cache_specs_shapes(arch):
    """A reduced model's real cache from ``prefill`` has ``cache_specs``'s
    keys, shapes and dtypes."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, "cpu")
    B, S, max_len = 2, 16, 24
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    args = (B, max_len)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    if type(model).__name__ == "EncDecModel":
        batch["frames"] = torch.from_numpy(rng.standard_normal((B, 12, cfg.d_model))
                                           .astype(np.float32))
        args = (B, max_len, 12)
    with torch.no_grad():
        _, cache = model.prefill(batch, max_len)
    specs = model.cache_specs(*args)
    assert sorted(cache) == sorted(specs)
    for k, t in cache.items():
        assert (tuple(t.shape), t.dtype) == (tuple(specs[k].shape), specs[k].dtype), k


def test_fit_spec_drops_what_does_not_divide():
    mesh, jmesh = _meshes("16x16")
    for spec, shape in (((None, "model"), (64, 256206)), (("data", None), (1, 8)),
                        ((("data", "model"), None), (512, 3)), (("model", "data"), (32, 48))):
        want = j_shl.fit_spec(jax.sharding.PartitionSpec(*spec), shape, jmesh)
        assert tuple(shl.fit_spec(spec, shape, mesh)) == tuple(want)
    assert shl.batch_axes(_meshes("2x16x16")[0]) == ("pod", "data")
    assert shl.replicated(mesh) == placements((), mesh)
