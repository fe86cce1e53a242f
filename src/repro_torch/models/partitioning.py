"""Logical-axis partitioning: map model axes onto a device mesh.

Port of ``repro/models/partitioning.py`` on DTensor.  Every activation and
parameter dimension has a *logical* name (batch, seq, embed, heads, kv,
head_dim, ff, experts, vocab, kv_seq, ...).  A rule set maps logical names
to mesh axes; ``spec(*names)`` gives the ``PartitionSpec`` (one entry a
tensor dimension: None, a mesh axis, or a tuple of mesh axes), and
``placements`` turns a spec into DTensor placements (``Shard(d)`` on each
mesh dimension that shards tensor dimension d, ``Replicate()`` on the
others).  ``shard(x, *names)`` redistributes a DTensor ``x`` to its spec
when a mesh is active, the counterpart of ``with_sharding_constraint``; it
is a no-op without a mesh and for a plain tensor, so the same model code
runs in the one-device tests.

Default rules implement the framework's parallelism layout:
  batch   -> ('pod', 'data')   data parallelism (hierarchical across pods)
  heads/ff/experts/vocab -> 'model'   tensor/expert parallelism
  kv_seq  -> 'model'           context parallelism for huge KV caches

A mesh here is anything with ``mesh_dim_names`` and ``shape``: a
``torch.distributed.device_mesh.DeviceMesh``, or ``AbstractMesh`` (axis
names and sizes without devices, for deriving shardings of a mesh this
process does not have).
"""
from __future__ import annotations

import contextlib
import functools
import math
import types
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]
Axes = Union[None, str, Tuple[str, ...]]

# The active mesh and rules: process-wide, not thread-local, since autograd
# runs the backward of CUDA tensors (and so a remat block's recompute) on
# its own device threads, which must see the mesh the forward saw.
_state = types.SimpleNamespace(mesh=None, rules=None)


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (replicated), a mesh axis name, or
    a tuple of mesh axis names (sharded over their product, major first).
    As in JAX, a tuple of one axis is that axis and an empty tuple None."""

    def __new__(cls, *parts: Axes):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple) else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's axis names and sizes, without devices or process groups."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)} differ in rank")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axis_names)
        self.ndim = len(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(mesh, axes: Axes) -> int:
    """The number of shards of ``axes`` (one axis name or a tuple) on ``mesh``."""
    if axes is None:
        return 1
    names = axis_names(mesh)
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        n *= tuple(mesh.shape)[names.index(a)]
    return n


def default_rules(mesh) -> Rules:
    axes = axis_names(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    model = "model" if "model" in axes else None
    return {
        "batch": batch,
        "seq": None,
        "dec_seq": None,
        "embed": None,
        "heads": model,
        "kv": None,        # kv heads often < model axis; replicate by default
        "head_dim": None,
        "ff": model,
        "experts": model,
        "expert_cap": None,
        "vocab": model,
        "kv_seq": model,   # context parallelism for 500k-token caches
        "state": None,
        "layers": None,
        "frames": None,
    }


def set_mesh(mesh, rules: Optional[Rules] = None) -> None:
    _state.mesh = mesh
    _state.rules = dict(default_rules(mesh), **(rules or {}))


def get_mesh():
    return getattr(_state, "mesh", None)


def get_rules() -> Rules:
    r = getattr(_state, "rules", None)
    return r if r is not None else default_rules(None)


def spec(*logical_axes: Optional[str]) -> PartitionSpec:
    rules = get_rules()
    return P(*(None if name is None else rules.get(name) for name in logical_axes))


def fit(spec_: Sequence[Axes], shape: Sequence[int], mesh) -> PartitionSpec:
    """``spec_`` padded to ``len(shape)`` entries, with the sharding dropped on
    the dims that its mesh axes do not divide (a vocabulary of 256206 over 16
    shards, a global batch of 1): those stay replicated."""
    parts = list(spec_) + [None] * (len(shape) - len(spec_))
    return P(*(None if axes is not None and dim % axis_size(mesh, axes) else axes
               for dim, axes in zip(shape, parts)))


def placements(spec_: Sequence[Axes], mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec_`` on ``mesh``: ``Shard(d)`` on every mesh
    dimension that shards tensor dimension d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec_):
        for a in () if axes is None else (axes,) if isinstance(axes, str) else axes:
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of {tuple(spec_)}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def replicated_placements(mesh) -> Tuple[Any, ...]:
    """``Replicate()`` on every dimension of ``mesh``."""
    return placements((), mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """Redistribute a DTensor to ``want``, and its gradient to ``want`` too:
    the transpose of JAX's ``with_sharding_constraint`` constrains the
    cotangent to the same sharding.  (DTensor's own redistribute would hand
    back the gradient of a reduced partial sum as a partial sum, and leave
    the next product to gather its weight instead.)"""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x) if tuple(x.placements) == want else \
            x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if is_dtensor(grad) and tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(grad.device_mesh, ctx.want)
        return grad, None


def _wanted(x: torch.Tensor, logical_axes) -> Optional[Tuple[Any, ...]]:
    """The placements of ``x``'s logical axes on the active mesh, or None
    where ``x`` keeps its own (no mesh, a plain tensor, or already there)."""
    mesh = get_mesh()
    if mesh is None or not is_dtensor(x):
        return None
    assert len(logical_axes) == x.ndim, (logical_axes, tuple(x.shape))
    want = placements(fit(spec(*logical_axes), x.shape, mesh), mesh)
    return None if tuple(x.placements) == want else want


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements of its logical axes, and its
    gradient to the same placements (a no-op without a mesh and for a plain
    tensor)."""
    want = _wanted(x, logical_axes)
    return x if want is None else _Constrain.apply(x, want)


# a dim of ``shard_uneven`` that keeps its own sharding: JAX's
# ``PartitionSpec.UNCONSTRAINED``, which ``vmap`` gives a constraint's
# batched dim
UNCONSTRAINED = "unconstrained"


def _chunks(n: int, k: int) -> list:
    """DTensor's chunks of a dim of ``n`` over ``k`` ranks: ceil(n / k) a
    rank, the last ones shorter or empty."""
    c = -(-n // k)
    return [max(0, min(c, n - r * c)) for r in range(k)]


def _all_to_all(t: torch.Tensor, mesh, i: int, gather: int, split: int,
                gathered: int) -> torch.Tensor:
    """A rank's shard ``t`` whose dim ``gather`` is its chunk of ``gathered``
    over mesh dim ``i`` and whose dim ``split`` is whole there, turned into
    the shard with ``gather`` whole and ``split`` chunked: one all-to-all
    over mesh dim ``i`` of flat pieces (chunks may be uneven or empty)."""
    import torch.distributed._functional_collectives as funcol

    k, me = mesh.size(i), mesh.get_local_rank(i)
    send, recv = _chunks(t.shape[split], k), _chunks(gathered, k)
    rest = math.prod(n for d, n in enumerate(t.shape) if d not in (gather, split))
    x = t.movedim(split, 0)
    g = gather + 1 if gather < split else gather      # gather's dim in x
    out = funcol.all_to_all_single(
        x.contiguous().reshape(-1), [send[me] * r * rest for r in recv],
        [s * recv[me] * rest for s in send], (mesh, i))
    shapes = [(send[me], *x.shape[1:g], r, *x.shape[g + 1:]) for r in recv]
    parts = torch.split(out, [math.prod(s) for s in shapes])
    # one copy into the rank's contiguous shard
    return torch.cat([p.reshape(s).movedim(0, split) for p, s in zip(parts, shapes)], dim=gather)


def _move(x: torch.Tensor, want: Tuple[Any, ...]) -> torch.Tensor:
    """DTensor ``x`` redistributed to ``want``: a mesh dim that moves the
    sharding from one tensor dim to another by an all-to-all of our own (on
    every backend: DTensor's own would all-gather on gloo), the others by
    DTensor's redistribute."""
    from torch.distributed.tensor import DTensor

    mesh, cur, local = x.device_mesh, list(x.placements), x.to_local()
    for i, (p, w) in enumerate(zip(x.placements, want)):
        if p.is_shard() and w.is_shard() and p.dim != w.dim:
            cur[i] = w
            gathered = local_shape_and_offset(x.shape, mesh, cur)[0][p.dim]
            local = _all_to_all(local, mesh, i, p.dim, w.dim, gathered)
    out = DTensor.from_local(local, mesh, tuple(cur), shape=x.shape,
                             stride=contiguous_strides(x.shape))
    return out if tuple(cur) == want else out.redistribute(mesh, want)


class _Move(torch.autograd.Function):
    """``_move`` to ``want``, and its gradient to ``want`` (as ``_Constrain``)
    and back to the input's placements by the inverse moves (a partial sum's
    gradient is replicated)."""

    @staticmethod
    def forward(ctx, x, want):
        from torch.distributed.tensor import Replicate

        ctx.want = want
        ctx.src = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return _move(x, want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(grad.device_mesh, ctx.want)
        return _move(grad, ctx.src), None


def shard_uneven(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``shard`` without ``fit``: a dim that its mesh axes do not divide is
    split unevenly, in DTensor's chunks, as the reference's
    ``with_sharding_constraint`` keeps it (60 experts over 16 ranks: 4 a rank,
    the last none).  A dim named ``UNCONSTRAINED`` keeps x's sharding on the
    mesh dims that no named dim takes.  A move of a mesh dim's sharding from
    one tensor dim to another is an all-to-all, and so is its gradient's.  A
    no-op without a mesh and for a plain tensor."""
    mesh = get_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    assert len(logical_axes) == x.ndim, (logical_axes, tuple(x.shape))
    named = spec(*(None if a == UNCONSTRAINED else a for a in logical_axes))
    want = list(placements(named, mesh))
    for i, p in enumerate(x.placements):
        if want[i].is_replicate() and p.is_shard() and logical_axes[p.dim] == UNCONSTRAINED:
            want[i] = p
    want = tuple(want)
    return x if tuple(x.placements) == want else _Move.apply(x, want)


def _spans(n: int, k: int, unit: int = 1) -> list:
    """(start, stop) of each rank's chunk (``_chunks``) of a dim of ``n``
    units over ``k`` ranks, in elements of ``unit`` each."""
    out, at = [], 0
    for c in _chunks(n, k):
        out.append((at * unit, (at + c) * unit))
        at += c
    return out


Ranges = Sequence[Tuple[int, int]]


def _position(ranges: Ranges, at: int) -> int:
    """Where index ``at`` of a dim lies in a tensor that holds the dim's
    ``ranges`` concatenated in order."""
    pos = 0
    for a, b in ranges:
        if a <= at < b:
            return pos + at - a
        pos += b - a
    raise ValueError(f"index {at} is not in {list(ranges)}")


def regather_plan(have: Sequence[Ranges], want: Sequence[Ranges], r: int) -> list:
    """Rank ``r``'s ``want[r]`` ranges of a dim, in order, as pieces (source
    rank, start, stop) of the ranks' ``have``: an index comes from rank r
    itself where it holds it, else from the lowest rank that does (B and C
    columns, which every rank holds).  Plain arithmetic, the same on every
    rank."""
    cuts = sorted({e for h in have for rng in h for e in rng})
    out: list = []
    for a, b in want[r]:
        edges = [a] + [c for c in cuts if a < c < b] + [b]
        for u, v in zip(edges, edges[1:]):
            if u == v:
                continue
            held = [s for s, h in enumerate(have) if any(x <= u and v <= y for x, y in h)]
            if not held:
                raise ValueError(f"no rank holds [{u}, {v}) of {list(map(list, have))}")
            s = r if r in held else held[0]
            if out and out[-1][0] == s and out[-1][2] == u:
                out[-1] = (s, out[-1][1], v)
            else:
                out.append((s, u, v))
    return out


def _narrow_cat(t: torch.Tensor, dim: int, pieces: Ranges) -> torch.Tensor:
    """``t``'s (start, stop) pieces of ``dim``, concatenated (``t`` itself
    where they are all of it, in order)."""
    merged: list = []
    for a, b in pieces:
        if merged and merged[-1][1] == a:
            merged[-1] = (merged[-1][0], b)
        elif b > a:
            merged.append((a, b))
    if merged == [(0, t.shape[dim])]:
        return t
    parts = [t.narrow(dim, a, b - a) for a, b in merged] or [t.narrow(dim, 0, 0)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def regather_local(ts: Sequence[torch.Tensor], dim: int, have: Sequence[Ranges],
                   want: Sequence[Ranges]) -> list:
    """``regather`` on one device: ``ts[r]`` is rank r's tensor of its ``have[r]``
    ranges; -> each rank's tensor of its ``want[r]`` ranges, taken where
    ``regather_plan`` takes them (what the collective computes)."""
    return [torch.cat([ts[s].narrow(dim, _position(have[s], u), v - u)
                       for s, u, v in regather_plan(have, want, r)] or [ts[r].narrow(dim, 0, 0)],
                      dim=dim)
            for r in range(len(want))]


def _sent(have: Sequence[Ranges], plans: list, me: int) -> list:
    """The pieces of rank ``me``'s tensor that each rank's plan takes from
    it: a list, a rank, of (position in ``me``'s tensor, length)."""
    return [[(_position(have[me], u), v - u) for s, u, v in plan if s == me] for plan in plans]


def _exchange(x: torch.Tensor, send: list, recv: list, mesh, i: int) -> torch.Tensor:
    """One all-to-all over mesh dim ``i`` of ``x``'s rows (dim 0): ``send[r]``
    rows to rank r, ``recv[s]`` from rank s."""
    import torch.distributed._functional_collectives as funcol

    rest = math.prod(x.shape[1:])
    out = funcol.all_to_all_single(x.contiguous().reshape(-1), [n * rest for n in recv],
                                   [n * rest for n in send], (mesh, i))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = out.wait()
    return out.reshape(sum(recv), *x.shape[1:])


def _cat_rows(parts: list, like: torch.Tensor) -> torch.Tensor:
    return torch.cat(parts) if parts else like[:0]


class _Regather(torch.autograd.Function):
    """``regather``'s all-to-all; the gradient goes back to the pieces'
    sources, summed where several ranks took the same index."""

    @staticmethod
    def forward(ctx, t, mesh, i, dim, have, plans):
        k, me = len(plans), mesh.get_local_rank(i)
        ctx.args, ctx.n = (mesh, i, dim, have, plans), t.shape[dim]
        x = t.movedim(dim, 0)
        sent = _sent(have, plans, me)
        recv = [sum(v - u for s_, u, v in plans[me] if s_ == s) for s in range(k)]
        buf = _exchange(_cat_rows([x.narrow(0, p, n) for pieces in sent for p, n in pieces], x),
                        [sum(n for _, n in pieces) for pieces in sent], recv, mesh, i)
        got, taken, parts = torch.split(buf, recv), [0] * k, []
        for s, u, v in plans[me]:       # each source's rows arrive in plan order
            parts.append(got[s].narrow(0, taken[s], v - u))
            taken[s] += v - u
        return _cat_rows(parts, buf).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        mesh, i, dim, have, plans = ctx.args
        k, me = len(plans), mesh.get_local_rank(i)
        g = grad.movedim(dim, 0)
        rows, at = [[] for _ in range(k)], 0
        for s, u, v in plans[me]:       # back to each source, in plan order
            rows[s].append(g.narrow(0, at, v - u))
            at += v - u
        sent = _sent(have, plans, me)
        back = _exchange(_cat_rows([p for r in rows for p in r], g),
                         [sum(p.shape[0] for p in r) for r in rows],
                         [sum(n for _, n in pieces) for pieces in sent], mesh, i)
        idx = [torch.arange(p, p + n, device=back.device) for pieces in sent for p, n in pieces]
        out = back.new_zeros((ctx.n, *back.shape[1:]))
        if idx:
            out.index_add_(0, torch.cat(idx), back)
        return out.movedim(0, dim), None, None, None, None, None


def regather(t: torch.Tensor, mesh, i: Optional[int], dim: int, have: Optional[Sequence[Ranges]],
             want: Sequence[Ranges]) -> torch.Tensor:
    """This rank's ``want[me]`` ranges of a dim (``dim`` of ``t``), in order,
    where rank r's ``t`` holds the ``have[r]`` ranges (``have`` None: ``t``
    is the whole dim on every rank, and the ranges are sliced locally, their
    gradient zero elsewhere).  Ranks may want overlapping ranges (every
    rank takes the B and C columns) and may hold overlapping ones (a
    write-back of them): ``regather_plan`` picks each index's source.  One
    all-to-all over mesh dim ``i`` of uneven or empty pieces, none where
    every rank holds what it wants; the gradient goes back to the sources,
    summed over the ranks that took an index."""
    me = 0 if i is None else mesh.get_local_rank(i)
    if have is None:
        return _narrow_cat(t, dim, want[me])
    plans = [regather_plan(have, want, r) for r in range(len(want))]
    if all(s == r for r, plan in enumerate(plans) for s, _, _ in plan):
        return _narrow_cat(t, dim, [(_position(have[me], u), _position(have[me], u) + v - u)
                                    for _, u, v in plans[me]])
    return _Regather.apply(t, mesh, i, dim, [list(h) for h in have], plans)


class _AllSum(torch.autograd.Function):
    """The sum of ``t`` over mesh dim ``i`` on every rank (an all-reduce);
    its gradient is the sum of the ranks' gradients, another all-reduce."""

    @staticmethod
    def forward(ctx, t, mesh, i):
        ctx.group = (mesh, i)
        return _all_reduce(t, mesh, i)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, *ctx.group), None, None


def _all_reduce(t: torch.Tensor, mesh, i: int) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_reduce(t.contiguous(), "sum", (mesh, i))
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out


def all_sum(t: torch.Tensor, mesh, i: Optional[int]) -> torch.Tensor:
    """A plain tensor summed over mesh dim ``i`` (as it is for ``i`` None)."""
    return t if i is None else _AllSum.apply(t, mesh, i)


def axis_rank(mesh, name: str) -> Tuple[Optional[int], int, int]:
    """(the mesh dim that the logical axis ``name`` maps to, its size, this
    rank's coordinate on it), or (None, 1, 0) where the rules map it to no
    mesh axis or to one of size 1."""
    axes = spec(name)[0]
    if axes is None:
        return None, 1, 0
    assert isinstance(axes, str), (name, axes)
    i = axis_names(mesh).index(axes)
    return (None, 1, 0) if mesh.size(i) == 1 else (i, mesh.size(i), mesh.get_local_rank(i))


def relayout(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``shard`` whose gradient comes back in ``x``'s own placements (DTensor's
    redistribute): for a layout the forward needs for one op only (a split
    along a sharded dim) and the backward should not keep."""
    want = _wanted(x, logical_axes)
    return x if want is None else x.redistribute(x.device_mesh, want)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank, as a plain tensor whose
    gradient is the same on every rank (a plain tensor as it is)."""
    if not is_dtensor(t):
        return t
    rep = replicated_placements(t.device_mesh)
    return t.redistribute(t.device_mesh, rep).to_local(grad_placements=rep)


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, computed whole on every rank, as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor (``t`` as it is otherwise)."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, replicated_placements(ref.device_mesh))


def _local(t, mesh, want, grad):
    return t.redistribute(mesh, want).to_local(grad_placements=grad) if is_dtensor(t) else t


def batch_local(fn, x: torch.Tensor, *weights, states=None, split=None):
    """``fn(x, *weights)`` run on this rank's shard of the batch, with the
    weights (dicts of tensors, or tensors) gathered whole, the counterpart
    of a ``shard_map`` over the batch axes: for the blocks that the
    reference replicates and whose ops have no DTensor sharding rules
    (xLSTM's recurrences; Mamba2's layers split their heads instead,
    ``ssm.mamba2_sharded``).  A plain ``x`` runs ``fn`` as it is.  The
    rank's weight gradients are partial sums over the batch axes
    (replicated over the others), and the output keeps x's batch sharding
    (dim 0), as does every tensor of a tuple ``fn`` returns (a prefill's
    final states).  ``states``: a tuple of recurrent states whose dim 0 is
    the batch (a decode step's), handed to ``fn`` as one more argument,
    each as the rank's batch shard whole over its other dims.  ``split``:
    the ``EmbedSplit`` of a decode step under ``embed_split``, whose ``fn``
    returns only its chunk of the last dim of its first output (the
    residual stream's d): that output is placed split over the batch axes."""
    if not is_dtensor(x):
        return fn(x, *weights) if states is None else fn(x, *weights, states)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils._pytree import tree_map

    mesh = x.device_mesh
    xp = placements(fit(spec("batch", *(None,) * (x.ndim - 1)), x.shape, mesh), mesh)
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in xp)
    rep = replicated_placements(mesh)
    local_w = [{k: _local(t, mesh, rep, grad) for k, t in w.items()} if isinstance(w, dict)
               else _local(w, mesh, rep, grad) for w in weights]
    args = (_local(x, mesh, xp, xp), *local_w)
    if states is not None:
        args += (tuple(_local(t, mesh, xp, xp) for t in states),)
    out = fn(*args)
    first = None
    if split is not None:
        first, out = out[0], out[1:]
        first = DTensor.from_local(first, mesh, split.placements(first.ndim - 1, xp),
                                   shape=x.shape, stride=contiguous_strides(x.shape))
    out = tree_map(lambda t: DTensor.from_local(t, mesh, xp)
                   if isinstance(t, torch.Tensor) else t, out)
    return out if first is None else (first, *out)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n, k) -> (..., n * k), the inverse of ``split_heads``.  On a
    DTensor the merged dim keeps the heads' placement and so does its
    gradient.  Heads split unevenly over a mesh dim (forty over 16: 3 a
    rank, 384 columns, and none on the last two) go back to that dim's even
    chunks of the merged dim (320 columns, as a row-parallel ``wo`` is split)
    by an all-to-all, and their gradient by the inverse one; where those
    chunks are uneven too the heads are gathered."""
    n, k = t.shape[-2], t.shape[-1]
    flat_shape = (*t.shape[:-2], n * k)
    if get_mesh() is None or not is_dtensor(t):
        return t.reshape(flat_shape)
    mesh = t.device_mesh
    i = next((i for i, p in enumerate(t.placements)
              if p.is_shard(t.ndim - 2) and n % mesh.size(i)), None)
    if i is not None:
        m = mesh.size(i)
        if (n * k) % m:
            from torch.distributed.tensor import Replicate

            want = tuple(Replicate() if j == i else p for j, p in enumerate(t.placements))
            t = _Constrain.apply(t, want)
        else:
            from torch.distributed.tensor import DTensor

            local = t.to_local(grad_placements=t.placements)
            local = local.reshape(*local.shape[:-2], local.shape[-2] * k)
            local = regather(local, mesh, i, t.ndim - 2, [[c] for c in _spans(n, m, k)],
                             [[c] for c in _spans(n * k, m)])
            return DTensor.from_local(local, mesh, t.placements, shape=flat_shape,
                                      stride=contiguous_strides(flat_shape))
    flat = t.reshape(flat_shape)
    return _Constrain.apply(flat, tuple(t.placements))


def at_use(w: torch.Tensor, dtype: torch.dtype, keep_dim: Optional[int] = None) -> torch.Tensor:
    """Weight ``w`` as a layer uses it: cast to ``dtype`` and, for a DTensor,
    whole over the batch axes ("pod", "data"), which shard it only for
    storage (FSDP), its tensor-parallel dims still sharded: an all-gather
    at use, whose gradient is a reduce-scatter.  ``keep_dim`` stays sharded
    over them (the experts dim of an expert-parallel weight).  Without this
    DTensor may move the activations instead and compute a product whole
    over the batch on every data rank.  Under ``embed_split`` the weight
    stays as stored: "data" shards its embed dim, as it shards the
    activations', and each rank contracts (or produces) its own chunk of
    it."""
    w = w.to(dtype)
    if not is_dtensor(w) or split_axes():
        return w
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(w.device_mesh)
    want = tuple(Replicate() if isinstance(p, Shard) and names[i] in ("pod", "data")
                 and p.dim % w.ndim != keep_dim else p for i, p in enumerate(w.placements))
    return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)


# ------------------------------------------------------- a decode step at batch 1
def split_axes() -> Tuple[str, ...]:
    """The batch axes that "embed" maps to (``embed_split``: "data"), ()
    when it maps to none."""
    axes = get_rules().get("embed")
    axes = () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)
    return axes if axes and set(axes) <= {"pod", "data"} else ()


@contextlib.contextmanager
def _embed_rule(axes: Axes):
    """The active rules with "embed" mapped to ``axes`` inside the block."""
    prev = getattr(_state, "rules", None)
    if axes != get_rules().get("embed"):
        _state.rules = dict(get_rules(), embed=axes)
    try:
        yield
    finally:
        _state.rules = prev


def embed_split(batch: int):
    """Context manager: the scoped rule of a decode step whose batch the
    batch axes ("pod", "data") do not divide (B = 1 on 16 data ranks, where
    ``fit`` drops the batch split and the axes would idle), as the
    reference's compiled step lays it out: "embed" maps to "data", the
    axis over which FSDP shards the weights' embed dim ("pod" replicates
    them), so the residual stream's d is split over it where the batch
    cannot be.  Weights stay where they are stored (``at_use`` gathers
    nothing), a product that contracts d gives partial sums over "data",
    reduced where the next op needs the vector, and a product that makes d
    gives each rank its own chunk.  K7 splits its heads over the batch
    axes (``ops.sharded_decode_attention``).  A no-op without a mesh or a
    "data" batch axis, under a rule that maps "embed" already, or where the
    batch axes split the batch."""
    mesh, rules = get_mesh(), get_rules()
    axes = rules.get("batch")
    fire = (mesh is not None and "data" in ((axes,) if isinstance(axes, str) else axes or ())
            and rules.get("embed") is None and batch % axis_size(mesh, axes))
    return _embed_rule("data" if fire else rules.get("embed"))


def split_decode(decode_step):
    """Decorator of a model's ``decode_step(self, tokens, ...)``: the step
    runs under ``embed_split(tokens.shape[0])``."""
    @functools.wraps(decode_step)
    def step(self, tokens, *args, **kwargs):
        with embed_split(tokens.shape[0]):
            return decode_step(self, tokens, *args, **kwargs)

    return step


def embed_whole():
    """Context manager: ``embed_split`` suspended, for a block that keeps its
    own layout (an MoE block, whose routes take x whole over its embed dim
    and gather their weights over the batch axes)."""
    return _embed_rule(None if split_axes() else get_rules().get("embed"))


class EmbedSplit:
    """This rank's part of a step under ``embed_split``, for code on local
    tensors: the mesh dims of the split axes, and the rank's chunk of a dim
    split over them (DTensor's chunks over the mesh dims in order, major
    first, as a DTensor sharded over them holds it)."""

    def __init__(self, mesh):
        names = axis_names(mesh)
        self.mesh = mesh
        self.dims = tuple(names.index(a) for a in split_axes())

    def placements(self, dim: int, others: Sequence[Any]) -> Tuple[Any, ...]:
        """``others`` with ``Shard(dim)`` on the split's mesh dims."""
        from torch.distributed.tensor import Shard

        return tuple(Shard(dim) if i in self.dims else p for i, p in enumerate(others))

    def span(self, n: int) -> Tuple[int, int]:
        """(start, stop) of this rank's chunk of a dim of ``n``."""
        (size,), (start,) = local_shape_and_offset(
            (n,), self.mesh, self.placements(0, replicated_placements(self.mesh)))
        return start, start + size

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A partial sum over the split's ranks, summed (an all-reduce)."""
        for i in self.dims:
            if self.mesh.size(i) > 1:
                t = _all_reduce(t, self.mesh, i)
        return t

    def contract(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` (x whole over its last dim, d) from this rank's rows of
        ``w`` against its chunk of x, the partial sums reduced."""
        a, b = self.span(w.shape[0])
        return self.sum(x[..., a:b] @ w[a:b].to(x.dtype))

    def produce(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """This rank's columns of ``h @ w`` (its chunk of the output d)."""
        a, b = self.span(w.shape[1])
        return h @ w[:, a:b].to(h.dtype)


def local_split() -> Optional[EmbedSplit]:
    """The active ``embed_split`` as an ``EmbedSplit`` of the mesh, or None."""
    mesh = get_mesh()
    return EmbedSplit(mesh) if mesh is not None and split_axes() else None


def split_heads(t: torch.Tensor, n: int, name: str, *lead: Optional[str],
                uneven: bool = False) -> torch.Tensor:
    """(..., n * k) -> (..., n, k), the new dim ``n`` under the logical axis
    ``name`` (``lead`` names the leading dims).  A DTensor is first
    redistributed so that the split is even on every rank: the flat dim
    sharded where the rule shards ``n`` and the mesh divides it, whole
    otherwise (one kv head on a model axis of 16 stays whole).  With
    ``uneven``, ``n`` heads that the rule's one mesh axis does not divide
    are split over it in DTensor's chunks instead, as the reference's
    constraint splits them (forty over 16: 3 a rank, none on the last two):
    the flat dim's even chunks (320 of 5120 columns) move to the ranks'
    heads (384, 128 or 0) by an all-to-all, and the gradient comes back to
    the flat dim's chunks (where those are uneven too, the heads stay
    whole)."""
    shape = (*t.shape[:-1], n, t.shape[-1] // n)
    mesh = get_mesh()
    if mesh is None or not is_dtensor(t):
        return t.reshape(shape)
    axes = spec(name)[0]
    i = axis_names(mesh).index(axes) if isinstance(axes, str) else None
    if uneven and i is not None and n % mesh.size(i) and t.shape[-1] % mesh.size(i) == 0:
        return _split_uneven(t, shape, lead, i)
    want = placements(fit(spec(*lead, name, None), shape, mesh), mesh)
    if tuple(t.placements) != want:
        t = t.redistribute(t.device_mesh, want)
    return t.reshape(shape)


def _split_uneven(t: torch.Tensor, shape: tuple, lead, i: int) -> torch.Tensor:
    """``split_heads``'s uneven split of ``t``'s last dim into ``shape``'s
    heads over mesh dim ``i`` (see there)."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, m, d = t.device_mesh, t.device_mesh.size(i), t.ndim - 1
    want = list(placements(fit(spec(*lead, None), t.shape, mesh), mesh))
    want[i] = Shard(d)
    want = tuple(want)
    if tuple(t.placements) != want:
        t = _Constrain.apply(t, want)
    local = regather(t.to_local(grad_placements=want), mesh, i, d,
                     [[c] for c in _spans(t.shape[-1], m)],
                     [[c] for c in _spans(shape[-2], m, shape[-1])])
    local = local.reshape(*local.shape[:-1], local.shape[-1] // shape[-1], shape[-1])
    return DTensor.from_local(local, mesh, want, shape=shape, stride=contiguous_strides(shape))


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def local_shape_and_offset(shape: Sequence[int], mesh, placements_: Sequence[Any]
                           ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(the shape of this rank's shard of a ``shape`` tensor with
    ``placements_`` on ``mesh``, its offset in each dim), as DTensor cuts
    it: ``Shard(d)`` on mesh dim i splits dim d into ``mesh.size(i)``
    chunks of ceil(n / k) (the last ones shorter or empty), mesh dims in
    order.  Plain arithmetic on the rank's mesh coordinate: it reads no
    tensor, so it also runs under ``FakeTensorMode``."""
    from torch.distributed.tensor import Shard

    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            d = p.dim % len(local)
            n, k = local[d], mesh.size(i)
            chunk = -(-n // k)
            start = min(coord[i] * chunk, n)
            offset[d] += start
            local[d] = min(chunk, n - start)
    return tuple(local), tuple(offset)


def zeros(shape: Sequence[int], *logical_axes: Optional[str], dtype: torch.dtype,
          device) -> torch.Tensor:
    """Zeros of ``shape``.  Under a mesh of more than one rank (a
    ``DeviceMesh``), a DTensor placed by the logical axes' spec (fitted to
    the shape) of which each rank allocates only its own shard: how the
    models make a sharded cache.  A plain tensor otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = get_mesh()
    if not isinstance(mesh, DeviceMesh) or mesh.size() == 1:
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    axes = (None,) * (len(shape) - len(logical_axes)) + tuple(logical_axes)
    want = placements(fit(spec(*axes), shape, mesh), mesh)
    local, _ = local_shape_and_offset(shape, mesh, want)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, want,
                              shape=tuple(shape), stride=contiguous_strides(shape))


def write_slots(cache: torch.Tensor, t: torch.Tensor, start: int) -> None:
    """``cache[:, start:start + n] = t`` (n = t.shape[1]) in place, in the
    cache's dtype.  On a DTensor cache (batch over dim 0, slots over dim 1,
    as ``launch/shardings.py::cache_spec`` places KV caches) every rank
    writes only into its own shard: ``t`` comes to the rank with the cache's
    placements when it covers every slot (a prefill of the whole window:
    the rank's slots arrive without a gather), else with the cache's batch
    split and whole over the slots, and the rank writes the slots of [start,
    start + n) that its shard holds, if any (a decode step's one slot, on
    the rank that holds it).  The cache itself is never gathered, and no
    DTensor setitem runs on its sharded dim."""
    n = t.shape[1]
    if not is_dtensor(cache):
        cache[:, start:start + n] = t.to(cache.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, replicated_placements(mesh))
    if start == 0 and n == cache.shape[1]:
        want = tuple(cache.placements)
    else:
        want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                     for p in cache.placements)
    tl = t.redistribute(mesh, want).to_local()
    local = cache._local_tensor          # the rank's shard: writes reach the cache
    if want == tuple(cache.placements):
        local.copy_(tl)
        return
    t0 = local_shape_and_offset(cache.shape, mesh, cache.placements)[1][1]
    lo, hi = max(start, t0), min(start + n, t0 + local.shape[1])
    if lo < hi:
        local[:, lo - t0:hi - t0] = tl[:, lo - start:hi - start].to(local.dtype)


def named_sharding(*logical_axes: Optional[str]):
    """(mesh, placements) of the logical axes on the active mesh, or None
    without one."""
    mesh = get_mesh()
    if mesh is None:
        return None
    return mesh, placements(spec(*logical_axes), mesh)


class use_mesh:
    """Context manager: activate (mesh, rules) for model code; nests, and
    restores the enclosing mesh and rules on exit."""

    def __init__(self, mesh, rules: Optional[Rules] = None):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        self._prev = (get_mesh(), getattr(_state, "rules", None))
        set_mesh(self.mesh, self.rules)
        return self

    def __exit__(self, *exc):
        _state.mesh, _state.rules = self._prev
        return False
