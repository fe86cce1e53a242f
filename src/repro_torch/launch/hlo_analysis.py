"""Static per-device profile of one call: FLOPs, bytes, collectives, memory.

Port of ``repro/launch/hlo_analysis.py``.  The reference walks the text of
XLA's compiled, SPMD-partitioned HLO and multiplies each ``while`` body by
its trip count.  Eager PyTorch has no HLO: a function is the sequence of
ATen ops it dispatches.  ``analyze`` runs the function once under a
``TorchDispatchMode`` and adds up what each op does; run under
``FakeTensorMode`` (the dry run) nothing is computed or allocated.  No
trip count is needed: eager code dispatches every iteration of a loop, so
a layer loop or a scan is counted as many times as it runs.  On DTensors
the mode lets DTensor run first (it returns ``NotImplemented`` for them)
and sees the local ops each rank runs on its shards, so every figure is
per device, as the reference's post-partitioning figures are.  Ops that
DTensor's sharding propagation runs on whole-shape fake tensors (to learn
an output's shape) are not counted.

The conventions are the reference's, carried over to ATen ops:

* **flops**: ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, SDPA) plus the hand-written attention kernels' own work,
  which their wrappers report for each launch (``kernels/build.py::
  record_work``: K6 counts the causal (row, key) pairs it computes, K7 the
  slots of each row; the reference's HLO counts the masked dots too).
* **bytes**: an HBM-traffic proxy.  Every op's result bytes (each produced
  tensor written once), except views, reshapes and allocations; operand
  bytes of matmuls and of K6/K7 (the streams into the tensor cores); for
  an in-place slice update (``index_put_``, ``scatter_`` ..., the
  counterpart of ``dynamic-update-slice``) the payload, not the buffer.
  A ``copy_`` into a slice view charges the view, which is its payload.
* **transcendental**: result elements of exp, tanh, log, rsqrt, pow, sin
  and cos, and of the softmax ops, whose exp XLA's HLO shows as one; plus
  the kernels' exp (and tanh) of each score.
* **collectives**: result bytes of each functional collective, by kind
  under the reference's names (``all_gather_into_tensor`` ``all-gather``,
  ``all_reduce`` ``all-reduce``, ``reduce_scatter_tensor``
  ``reduce-scatter``, ``all_to_all_single`` ``all-to-all``), and their
  counts.

Memory, the counterparts of XLA's ``memory_analysis()``, per device, from
storage tracking of our own (each tensor storage an op creates is live
from its creation until Python frees it, by a weak reference; a FakeTensor
has a storage of the real size): ``argument_size_in_bytes`` the local
shards of the arguments, ``output_size_in_bytes`` the storages of the
result, ``alias_size_in_bytes`` the arguments named as donated (updated in
place: the train state, the decode cache), ``temp_size_in_bytes`` the peak
of live local bytes during the call minus the arguments.  The caching
allocator's rounding is not modelled.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import build

COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
_TRANSCENDENTAL = {"exp", "tanh", "log", "rsqrt", "pow", "sin", "cos", "_softmax",
                   "_log_softmax", "_safe_softmax"}
_SCATTERS = {"index_put", "_index_put_impl", "index_copy", "scatter", "scatter_add",
             "scatter_reduce", "slice_scatter", "select_scatter", "index_add",
             "masked_scatter"}
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
                "lift_fresh", "wait_tensor", "detach", "alias", "_unsafe_view", "view",
                "reshape", "_reshape_alias"}


def _name(func) -> str:
    """An op's base name: ``aten.add_.Tensor`` -> ``add``."""
    return func._overloadpacket.__name__.rstrip("_")


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct (local) storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


@contextlib.contextmanager
def _skipping_propagation(mode: "_Profile"):
    """Mark the ops DTensor's sharding propagation runs (on whole-shape
    fake tensors, to learn output shapes): they are not the rank's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        mode.skip += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            mode.skip -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


class _Profile(TorchDispatchMode):
    """Counts each dispatched op's work and tracks the storages it creates."""

    def __init__(self):
        super().__init__()
        self.skip = 0
        self.flops = self.bytes = self.transcendental = 0.0
        self.collectives: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.kernels: Dict[str, int] = {}
        self.live = self.peak = 0
        self._tracked: Dict[int, Any] = {}

    # ------------------------------------------------------------- memory
    def track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._tracked.pop(key, None) is not None:
                self.live -= n

        self._tracked[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    # -------------------------------------------------------------- kernels
    def kernel(self, name: str, flops: float, n_bytes: float, transcendental: float) -> None:
        if self.skip:
            return
        self.flops += flops
        self.bytes += n_bytes
        self.transcendental += transcendental
        self.kernels[name] = self.kernels.get(name, 0) + 1

    # ---------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor runs first; its local ops come back here
        kwargs = kwargs or {}
        if func is torch.ops._c10d_functional.wait_tensor.default and build.is_fake(args[0]):
            out = args[0]   # the fake kernel returns a new tensor; eager waits in place
        else:
            out = func(*args, **kwargs)
        if self.skip:
            return out
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        name = _name(func)
        ns = func.namespace
        res_bytes = sum(_nbytes(t) for t in outs)
        if ns in ("_c10d_functional", "c10d_functional") and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            self.collectives[kind] = self.collectives.get(kind, 0.0) + res_bytes
            self.counts[kind] = self.counts.get(kind, 0) + 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            res_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        if name in _TRANSCENDENTAL:
            self.transcendental += sum(t.numel() for t in outs)
        elif name == "logsumexp":
            self.transcendental += args[0].numel()
        if func.is_view or name in _ALLOCATIONS or not outs:
            return out
        if name in _SCATTERS:   # the payload: every tensor operand but the buffer
            ob = sorted(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(ob[:-1])
        else:
            self.bytes += res_bytes
        return out


def analyze(fn, *args, donate: Iterable[Any] = (), **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and profile it, per device.

    Returns the reference's keys, ``flops``, ``bytes``, ``transcendental``,
    ``collective_bytes``, ``collectives`` and ``collective_counts``, and
    the memory figures ``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``temp_size_in_bytes`` and ``alias_size_in_bytes`` (``donate``: the
    trees among the arguments that the call updates in place), with
    ``kernel_launches`` (the attention kernels' launches, fake or real),
    ``peak_bytes`` (arguments + temp), ``seconds`` and ``result`` (what
    ``fn`` returned)."""
    mode = _Profile()
    for t in _tensors((args, kwargs)):
        mode.track(t)
    arg_bytes = mode.live
    alias = storage_bytes(list(donate))
    t0 = time.perf_counter()
    with _skipping_propagation(mode), build.observe_work(mode.kernel), mode:
        result = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "transcendental": float(mode.transcendental),
            "collective_bytes": float(sum(mode.collectives.values())),
            "collectives": dict(mode.collectives), "collective_counts": dict(mode.counts),
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(storage_bytes(result)),
            "temp_size_in_bytes": int(mode.peak - arg_bytes),
            "alias_size_in_bytes": int(alias), "peak_bytes": int(mode.peak),
            "kernel_launches": dict(mode.kernels), "seconds": seconds, "result": result}
