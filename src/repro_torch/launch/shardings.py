"""Sharding derivation: map every parameter / optimizer / batch / cache leaf
onto a device mesh as DTensor placements.

Port of ``repro/launch/shardings.py``.  Parallelism layout:
  * TP over 'model': attention heads, MLP hidden, experts (EP), vocab
  * DP over ('pod', 'data'): batch
  * FSDP (optional, ``mode='fsdp'``): parameters + optimizer state
    additionally sharded over 'data' on their non-TP dimension
  * context parallelism: KV caches sharded over 'model' on the sequence dim
  * xlstm-125m: pure DP (125M params: TP would be all overhead)

Everything keys off leaf *names*: the port's dotted parameter names
(``layers.0.attn.wk``) and, in a train state, the optimizer's ``m`` / ``v``
/ ``error`` trees keyed by the same names, whose int8 moments are ``{"q",
"scale"}`` dicts (the payload keeps the parameter's shape, the scale drops
its last axis to 1).  So moments inherit their parameter's sharding.

The reference stacks a layer group's leaves on leading axes, (n_groups,
d, f) (hybrid and xLSTM groups on two); the port keeps one tensor a layer,
and each numeric part of its name is one of the reference's stacked axes
(``convert._stacked`` maps the two).  A rule here is evaluated at the
reference's rank and its spec taken on the port leaf's trailing dims, so
each leaf gets the reference's sharding of the same dims.

A function returns a tree of the input's structure whose leaves are tuples
of placements, one a mesh dimension (``partitioning.placements``);
``distribute`` places a tree of tensors with them.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

from ..models.partitioning import P, PartitionSpec, axis_names, fit, placements
from ..models.partitioning import replicated_placements as replicated  # noqa: F401

# parameter name -> which dim is TP-sharded, counted from the END of the
# leaf's *base* rank (the reference's tables).
_OUT_DIM = {  # project INTO sharded feature space: shard output (last) dim
    "wq", "wk", "wv", "wi", "in_proj", "up", "wx", "ff_wi", "router", "w_if",
}
_IN_DIM = {  # project OUT of sharded feature space: shard input dim
    "wo", "out_proj", "down", "ff_wo",
}
_EMBED = {"embed", "head"}
_REPLICATED = {
    "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm", "ln", "ln1", "ln2",
    "lnx", "pn1", "pn2", "final_norm", "enc_norm", "dec_norm", "b", "b_if",
    "bq", "bk", "bv", "q_norm", "k_norm", "r", "scale",
}


def _parts(path) -> Tuple[str, ...]:
    """A leaf's path (keys, or one dotted name) as its name parts."""
    keys = (path,) if isinstance(path, str) else tuple(path)
    return tuple(p for k in keys for p in str(k).split("."))


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, or the ``(shape, dtype)`` pair of
    ``input_specs``."""
    return tuple(leaf[0] if isinstance(leaf, tuple) else leaf.shape)


def _tree(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh)) or None


def fit_spec(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """Drop sharding on dims the mesh axes don't divide (seamless's 256206
    vocab % 16 != 0, or a global batch of 1): those stay replicated."""
    return fit(spec, shape, mesh)


def _rule(names: Tuple[str, ...], ndim: int, mesh, mode: str, family: str) -> PartitionSpec:
    """The reference's ``param_spec`` of a leaf named ``names`` of rank
    ``ndim`` (the reference's rank)."""
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    fsdp = "data" if (mode in ("fsdp", "ep") and "data" in axis_names(mesh)) else None

    if family == "ssm" and name not in _EMBED:
        return P()  # xlstm: replicate (pure DP)

    def lead(base: Tuple[Optional[str], ...]) -> PartitionSpec:
        extra = ndim - len(base)
        assert extra >= 0, (names, ndim, base)
        return P(*((None,) * extra + tuple(base)))

    if name in _EMBED:
        return lead(("model", fsdp))
    if parent == "moe" or (name in ("wi", "wo") and ndim >= 3 and "moe" in names):
        if name == "router":
            return lead((fsdp, "model"))
        if mode == "ep":
            # expert weights stationary: experts over 'data', hidden over
            # 'model'; tokens move, the expert weights never do
            if name == "wi":          # (E, d, 2f)
                return lead(("data", None, "model"))
            return lead(("data", "model", None))  # wo: (E, f, d)
        if name in ("wi", "wo"):      # (E, d_in, d_out): experts over model
            return lead(("model", fsdp, None))
    if name in _REPLICATED:
        return lead((None,) * min(ndim, 1)) if ndim else P()
    if name in _OUT_DIM and ndim >= 2:
        return lead((fsdp, "model"))
    if name in _IN_DIM and ndim >= 2:
        return lead(("model", fsdp))
    return P()  # conservative default: replicate


def param_spec(path, leaf, mesh, mode: str = "tp", family: str = "dense") -> PartitionSpec:
    """The spec of a port parameter leaf (``path`` its name or keys): the
    reference's rule at the reference's rank, on the leaf's own dims."""
    names = _parts(path)
    shape = _shape(leaf)
    stacked = sum(n.isdigit() for n in names)
    full = list(_rule(tuple(n for n in names if not n.isdigit()), len(shape) + stacked,
                      mesh, mode, family))
    full += [None] * (len(shape) + stacked - len(full))
    return fit(full[stacked:], shape, mesh)


def state_spec(path, leaf, mesh, mode: str = "tp", family: str = "dense") -> PartitionSpec:
    """The spec of a leaf of a {params, opt} train state (or a bare params
    dict): moments strip their ``m``/``v``/``error`` prefix and ``q``/
    ``scale`` suffix and take their parameter's rule; a scale's last dim
    (1) is never sharded; ``step`` is replicated."""
    names = _parts(path)
    if names and names[-1] == "step":
        return P()
    if names and names[0] in ("m", "v", "error", "params"):
        names = names[1:]
    is_scale = bool(names) and names[-1] == "scale"
    if is_scale or (names and names[-1] == "q"):
        names = names[:-1]
    spec = list(param_spec(names, leaf, mesh, mode, family))
    if is_scale and spec:
        spec[-1] = None
    return fit(spec, _shape(leaf), mesh)


def state_shardings(state_shapes, mesh, mode: str = "tp", family: str = "dense"):
    """Placements for a {params, opt} train state (or bare params dict)."""
    return _tree(lambda path, leaf: placements(
        state_spec(path, leaf, mesh, mode, family), mesh), state_shapes)


def batch_shardings(batch_specs, mesh):
    """Every input sharded over the batch axes on its first dim."""
    ba = batch_axes(mesh)

    def assign(path, leaf):
        shape = _shape(leaf)
        return placements(fit(P(ba, *(None,) * (len(shape) - 1)), shape, mesh), mesh)

    return _tree(assign, batch_specs)


_XLSTM_CACHE = {"mC": 4, "mn": 3, "mm": 2, "mbuf": 3, "sh": 3, "sc": 3, "sn": 3, "sm": 2,
                "sbuf": 3}


def cache_spec(name: str, leaf, mesh, family: str = "dense") -> PartitionSpec:
    """KV caches: batch over DP axes, sequence dim over 'model' (context
    parallelism); recurrent states: batch (and Mamba heads over 'model')."""
    ba = batch_axes(mesh)
    shape = _shape(leaf)
    if family == "ssm":
        # xlstm states: the batch is the first of the state's own dims
        base = (ba,) + (None,) * (_XLSTM_CACHE[name] - 1)
    elif name in ("ssm", "ssm_tail"):
        base = (ba, "model", None, None)        # (B, H, P, N): heads TP
    elif name in ("conv", "conv_tail"):
        base = (ba, None, "model")              # (B, W, conv_dim)
    elif name.startswith(("k", "v", "xk", "xv")):
        base = (ba, "model", None, None)        # (B, S, KV, D): seq CP
    else:
        base = (ba,) + (None,) * (len(shape) - 1)
    return fit(P(*((None,) * (len(shape) - len(base)) + base)), shape, mesh)


def cache_shardings(cache_specs, mesh, family: str = "dense"):
    return _tree(lambda path, leaf: placements(
        cache_spec(str(path[-1]), leaf, mesh, family), mesh), cache_specs)


def distribute(tree, shardings, mesh):
    """A tree of tensors as DTensors on ``mesh`` with the placements of the
    matching tree ``shardings``.  Every rank holds the same full tensors
    (a seeded draw, a checkpoint) and keeps its own shards: no data moves.
    A leaf whose shards are all of it (replicated, or sharded only over
    axes of size 1) keeps its storage; a leaf that already is a DTensor is
    redistributed.  On a mesh of one rank every shard is the whole tensor,
    and the tree comes back as plain tensors (a DTensor leaf as its local
    tensor): the model, the kernels' wrappers and the train step take both
    alike, and DTensor's dispatch would only cost host time."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    if mesh.size() == 1:
        return _tree(lambda _, t: t.to_local() if isinstance(t, DTensor) else t, tree)

    def place(path, t):
        want = _lookup(shardings, path)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == want else t.redistribute(mesh, want)
        if all(not isinstance(p, Shard) or mesh.size(i) == 1 for i, p in enumerate(want)):
            return DTensor.from_local(t.detach(), mesh, want)
        return distribute_tensor(t.detach(), mesh, want, src_data_rank=None)

    return _tree(place, tree)


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tuple(tree)

