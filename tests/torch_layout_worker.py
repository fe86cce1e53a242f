"""One rank of ``test_torch_layout_dist.py``'s sharded train steps (and of
``test_torch_sharded_decode.py``'s sharded serving).

``python tests/torch_layout_worker.py CASE RANK WORLD STORE OUT`` (with
``src`` on ``PYTHONPATH``) joins a gloo group through a ``FileStore`` at
STORE, builds a (2, WORLD / 2) ("data", "model") CPU mesh and, for CASE
(``ARCH:MODE``), runs two train steps of the reduced config twice from one
seeded state: on one device with plain tensors, and under ``use_mesh`` with
the state distributed by ``state_shardings`` and the batches by
``batch_shardings``.  It writes OUT (JSON): the two runs' losses, the
largest parameter gap, the largest gap of each gradient, and every state
leaf or gradient whose placements differ from ``state_shardings`` /
``grad_shardings`` (``ARCH:MODE:int8``: with int8 moments and int8
gradient compression; a part ``KEY=INT`` overrides a field of the reduced
config, ``moe_dispatch_groups=2``).  The
JSON also holds the token count of each ``moe.route`` call of the two runs
(``routes_plain``, ``routes_mesh``): a rank's own groups only; the dropped
(token, pick) pairs of each ``moe.dispatch`` call (``drops_plain``,
``drops_mesh``); and, of the
mesh run on this rank, the q heads of K6's calls (``k6_heads``), the
vocabulary columns of the loss's logits shards (``logit_cols``) and the
heads of each Mamba2 scan (``mamba_heads``).  CASE
``attention:gqa`` holds K6 on DTensors (``ops.flash_attention``: batch
over "data", heads over "model") and its gradients against plain tensors
at several head groupings instead.  CASE ``decode:ARCH`` serves: it loads
the parameters and inputs the test wrote beside STORE (``decode_in.pt``),
places the parameters with ``state_shardings`` ("fsdp"; ``decode:ARCH:KEY=INT``
overrides the reduced config as above), and under
``use_mesh`` runs a prefill (whose cache comes out placed as
``cache_shardings`` places it: slots over "model") and the decode steps,
writing each step's logits, every cache leaf whose placements differ and
the dropped pairs of each ``moe.dispatch`` call; and, of the decode steps,
each collective the rank runs (kind, mesh axis, input shape), the q and kv
heads of each K7 call, and the local shapes of the parameters that "data"
shards.  The batch is the test's (2, or 1: a batch that "data" does not
divide, decoded under ``embed_split``).
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.kernels import flash_attention
from repro_torch.launch import shardings as shl
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import build_model, layers, moe, ssm, use_mesh
from repro_torch.training import OptimizerConfig, init_state, make_train_step
from repro_torch.training import train_loop

STEPS = 2
SHAPE = ShapeSpec("layout", 32, 4, "train")


def _config(arch: str, parts) -> tuple:
    """(the reduced config of ``arch`` with the ``KEY=INT`` parts applied, the
    train shape (``seq=INT`` sets its length), the other parts)."""
    over = {k: int(v) for k, v in (p.split("=") for p in parts if "=" in p)}
    shape = dataclasses.replace(SHAPE, seq_len=over.pop("seq", SHAPE.seq_len))
    return (dataclasses.replace(get_arch(arch).reduced(), **over), shape,
            [p for p in parts if "=" not in p])


def _record_routes(log: list):
    """Wrap ``moe.route`` to append each call's token count to ``log``;
    returns the original."""
    route = moe.route

    def recording(params, xf, cfg):
        log.append(int(xf.shape[0]))
        return route(params, xf, cfg)

    moe.route = recording
    return route


def _record_drops(log: list):
    """Wrap ``moe.dispatch`` to append each call's dropped (token, pick)
    pairs to ``log``; returns the original."""
    dispatch = moe.dispatch

    def recording(expert_ids, n_experts, cap):
        out = dispatch(expert_ids, n_experts, cap)
        log.append(int((~out[2]).sum()))
        return out

    moe.dispatch = recording
    return dispatch


_FORWARD, _LSE_GOLD, _GATE = flash_attention.forward, layers.lse_gold, ssm.mamba2_gate


def _record_local_work():
    """Wrap K6's forward, ``layers.lse_gold`` and ``ssm.mamba2_gate`` to log,
    on this rank, the q heads of each K6 call, the vocabulary columns of
    each logits shard the loss takes and the heads of each Mamba2 scan;
    returns the three logs (``main`` restores all three)."""
    heads, cols, scans = [], [], []

    def forward(q, *args, **kw):
        heads.append(int(q.shape[2]))
        return _FORWARD(q, *args, **kw)

    def lse_gold(logits, labels):
        local = logits.to_local() if hasattr(logits, "to_local") else logits
        cols.append(int(local.shape[-1]))
        return _LSE_GOLD(logits, labels)

    def gate(params, *args, **kw):
        scans.append(int(params["A_log"].shape[0]))
        return _GATE(params, *args, **kw)

    flash_attention.forward, layers.lse_gold, ssm.mamba2_gate = forward, lse_gold, gate
    return heads, cols, scans


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def attention_case(mesh) -> dict:
    """K6 on DTensors against plain tensors, forward and gradients: (H, KV)
    with each rank's two heads covering a kv head (8, 4), lying within one
    (4, 1), one head a kv head (8, 8), heads that straddle kv groups on 2
    ranks (6, 3: rank 0's heads 0-2 read kv heads 0, 0, 1), straddling and
    split unevenly (9, 3: 5 heads and 4), and a rank without heads (1, 1:
    1 and 0).  Every case splits q's heads over "model"."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    gap, placed = 0.0, []
    for H, KV, kw in ((8, 4, {}), (4, 1, {"window": 5}), (8, 8, {"q_offset": 4}),
                      (6, 3, {"softcap": 20.0}), (9, 3, {}), (1, 1, {"q_offset": 2})):
        B, S, D = 4, 12, 16
        T = S + kw.get("q_offset", 0)
        q, w = (torch.randn(B, S, H, D, generator=gen) for _ in range(2))
        k, v = (torch.randn(B, T, KV, D, generator=gen) for _ in range(2))
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        (ops.flash_attention(*plain, **kw) * w).sum().backward()
        with use_mesh(mesh):
            dq = distribute_tensor(q, mesh, (Shard(0), Replicate())).requires_grad_()
            dk, dv = (distribute_tensor(x, mesh, (Shard(0), Replicate())).requires_grad_()
                      for x in (k, v))
            out = ops.flash_attention(dq, dk, dv, **kw)
            placed.append([p.dim if p.is_shard() else None for p in out.placements])
            (out * distribute_tensor(w, mesh, out.placements)).sum().full_tensor().backward()
        want = ops.flash_attention(q, k, v, **kw)
        for got, ref in ((out.full_tensor(), want), *((d.grad.full_tensor(), p.grad)
                                                      for d, p in zip((dq, dk, dv), plain))):
            gap = max(gap, float((got - ref).abs().max() / ref.abs().max()))
    return {"gap": gap, "placements": placed}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _conv_chunks(cache) -> dict:
    """This rank's shard of each conv buffer of a hybrid cache (``conv``,
    ``conv_tail``), as (its offset in each dim, its values)."""
    from repro_torch.models.partitioning import local_shape_and_offset

    return {k: {"offset": list(local_shape_and_offset(t.shape, t.device_mesh, t.placements)[1]),
                "local": t._local_tensor.tolist()}
            for k, t in cache.items() if k.startswith("conv")}


_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def _collective_log(mesh):
    """A dispatch mode that logs each functional collective this rank runs:
    [kind, the mesh axis of its group, its input's shape]."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    axes = {mesh.get_group(i).group_name: name for i, name in enumerate(mesh.mesh_dim_names)}

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.log = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            name = func._overloadpacket.__name__
            if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
                self.log.append([_COLLECTIVES[name], axes.get(args[-1], str(args[-1])),
                                 list(args[0].shape)])
            return func(*args, **(kwargs or {}))

    return Log()


def decode_case(arch: str, mesh, path, parts=()) -> dict:
    """A prefill and decode steps of ``arch`` on DTensors (see the module
    docstring): the logits of each (whole), the cache leaves whose
    placements differ from ``cache_shardings``, the leaves whose slots are
    sharded, and after each the rank's shards of the conv buffers; of the
    decode steps, the collectives this rank runs (``_collective_log``) and
    the (q heads, kv heads) of each K7 call, and the local shapes of the
    parameters sharded over "data"."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.func import functional_call

    from repro_torch.kernels import decode_attention as decode_k

    data = torch.load(path)
    cfg = _config(arch, parts)[0]
    model = build_model(cfg, "cpu")
    tokens, S, steps = data["tokens"], data["S"], data["steps"]
    pos0 = data.get("pos0", S)        # past a vision prompt's patch tokens

    class Call(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, fn, *args):
            return getattr(self.model, fn)(*args)

    call = Call()
    drops = []
    dispatch = _record_drops(drops)
    with use_mesh(mesh), implicit_replication(), torch.no_grad():
        params = shl.distribute(data["params"], shl.state_shardings(
            data["params"], mesh, "fsdp", cfg.family), mesh)
        named = {f"model.{n}": t for n, t in params.items()}
        batch = {"tokens": tokens[:, :S], **data["extra"]}
        batch = shl.distribute(batch, shl.batch_shardings(batch, mesh), mesh)
        logits, cache = functional_call(call, named, ("prefill", batch, data["max_len"],
                                                      torch.float32))
        got, conv = [logits.full_tensor().tolist()], [_conv_chunks(cache)]
        specs = {k: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
                 for k, t in cache.items()}
        want = shl.cache_shardings(specs, mesh, cfg.family)
        bad = [f"{k}: {tuple(t.placements)} != {tuple(want[k])}" for k, t in cache.items()
               if tuple(t.placements) != tuple(want[k])]
        tok_shd = shl.batch_shardings({"tokens": tokens[:, :1]}, mesh)["tokens"]
        k7, decode = [], decode_k.decode_attention

        def k7_logged(q, k, *args, **kw):
            k7.append([int(q.shape[1]), int(k.shape[2])])
            return decode(q, k, *args, **kw)

        decode_k.decode_attention = k7_logged
        collectives = _collective_log(mesh)
        for step in range(steps):
            nxt = shl.distribute({"t": tokens[:, S + step:S + step + 1]}, {"t": tok_shd},
                                 mesh)["t"]
            with collectives:
                logits, cache = functional_call(call, named,
                                                ("decode_step", nxt, cache, pos0 + step))
            got.append(logits.full_tensor().tolist())
            conv.append(_conv_chunks(cache))
        decode_k.decode_attention = decode
        data = mesh.mesh_dim_names.index("data")
        data_params = sorted({tuple(t.to_local().shape) for t in params.values()
                              if t.placements[data].is_shard()})
        bad += [f"{k} after decode: {tuple(t.placements)} != {tuple(want[k])}"
                for k, t in cache.items() if tuple(t.placements) != tuple(want[k])]
        sharded = sorted(k for k, t in cache.items()
                         if any(p.is_shard() and p.dim == t.ndim - 3 for p in t.placements)
                         and k[0] in "kvx")
    moe.dispatch = dispatch
    return {"logits": got, "bad": bad, "seq_sharded": sharded, "conv_chunks": conv,
            "drops": drops, "collectives": collectives.log, "k7_calls": k7,
            "data_params": data_params}


def main(case: str, rank: int, world: int, store: str, out: str) -> None:
    arch, mode, *parts = case.split(":")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    if arch in ("attention", "decode"):
        res = attention_case(mesh) if arch == "attention" else \
            decode_case(mode, mesh, Path(store).parent / "decode_in.pt", parts)
        with open(out, "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
        return
    cfg, shape, moments = _config(arch, parts)
    model = build_model(cfg, "cpu", seed=0, trainable=True)
    # ARCH:MODE:int8 takes int8 moments and int8 gradient compression
    ocfg = OptimizerConfig(moment_dtype="int8", compress_grads=True) if moments else \
        OptimizerConfig()
    base = _copy(init_state(model, ocfg))
    batches = [synthetic_batch(model, cfg, shape, s, "cpu") for s in range(STEPS)]

    seen = []   # (name, gradient) as the optimizer receives them
    update = train_loop.adamw_update

    def recording(params, grads, state, cfg_):
        seen.extend(grads.items())
        return update(params, grads, state, cfg_)

    train_loop.adamw_update = recording
    plain = _copy(base)
    plain_step = make_train_step(model, ocfg)
    routes_plain, routes_mesh, drops_plain, drops_mesh = [], [], [], []
    route, dispatch = _record_routes(routes_plain), _record_drops(drops_plain)
    want = [float(plain_step(plain, b)[1]["loss"]) for b in batches]
    plain_grads, seen = seen, []
    moe.route, moe.dispatch = route, dispatch
    _record_routes(routes_mesh)
    _record_drops(drops_mesh)

    rules = {"experts": "data"} if mode == "ep" else None
    heads, cols, scans = _record_local_work()
    with use_mesh(mesh, rules):
        shd = shl.state_shardings(base, mesh, mode, cfg.family)
        state = shl.distribute(_copy(base), shd, mesh)
        step = make_train_step(model, ocfg, grad_shardings=shd["params"])
        bshd = shl.batch_shardings(model.input_specs(shape), mesh)
        got = [float(step(state, shl.distribute(b, bshd, mesh))[1]["loss"]) for b in batches]
    train_loop.adamw_update = update
    moe.route, moe.dispatch = route, dispatch
    flash_attention.forward, layers.lse_gold, ssm.mamba2_gate = _FORWARD, _LSE_GOLD, _GATE

    def wanted(path):
        node = shd
        for k in path:
            node = node[k]
        return tuple(node)

    bad = [f"state {'/'.join(path)}: {tuple(t.placements)} != {wanted(path)}"
           for path, t in _leaves(state) if tuple(t.placements) != wanted(path)]
    bad += [f"grad {n}: {tuple(g.placements)} != {tuple(shd['params'][n])}"
            for n, g in seen if tuple(g.placements) != tuple(shd["params"][n])]
    # each gradient against the one-device run's, relative to its largest
    # value: the largest gap, and each parameter's over the steps
    grad_gaps = {}
    for (n, g), (_, w) in zip(seen, plain_grads):
        gap = float((g.full_tensor() - w).abs().max() / w.abs().max().clamp_min(1e-30))
        grad_gaps[n] = max(gap, grad_gaps.get(n, 0.0))
    grad_gap = max(grad_gaps.values())
    gap = max(float((t.full_tensor() - plain["params"][n]).abs().max())
              for n, t in state["params"].items())
    sharded = sum(any(not p.is_replicate() for p in shd["params"][n]) for n in shd["params"])
    with open(out, "w") as f:
        json.dump({"want": want, "got": got, "param_gap": gap, "grad_gap": grad_gap,
                   "grad_gaps": grad_gaps, "bad": bad,
                   "n_grads": len(seen), "n_sharded": sharded, "routes_plain": routes_plain,
                   "routes_mesh": routes_mesh, "drops_plain": drops_plain,
                   "drops_mesh": drops_mesh, "k6_heads": sorted(set(heads)),
                   "logit_cols": sorted(set(cols)), "mamba_heads": sorted(set(scans))}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
