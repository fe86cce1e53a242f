"""The port's per-device profile of a call (``launch/hlo_analysis.py``), on
the CPU.

The twins of ``TestHloAnalysis`` (tests/test_models_core.py): a loop of
matmuls counts every iteration (eager code dispatches each one, where the
reference multiplies XLA's while bodies by their trip counts), exactly.
Then the bytes convention (views 0, matmul operands charged, an in-place
slice update its payload), the transcendental count, the memory figures,
the collectives of known redistributes on a fake 4-rank mesh (in a
subprocess: a fake process group is process-wide), and K6 and K7 on
FakeTensors: their recorded work is the shared formula, only the kernel's
buffers are allocated, no launch is counted, and a real CPU tensor takes
the plain version, not the fake route.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as decode_k
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.launch.hlo_analysis import analyze

ROOT = Path(__file__).resolve().parents[1]


def test_loop_flops_exact():
    N, L = 128, 5

    def f(w, x):
        for _ in range(L):
            x = torch.tanh(x @ w)
        return x.sum()

    res = analyze(f, torch.randn(N, N), torch.randn(8, N))
    assert res["flops"] == 2 * 8 * N * N * L
    assert res["transcendental"] == 8 * N * L


def test_nested_loop_flops_exact():
    N = 64

    def f(w, x):
        for _ in range(4):
            for _ in range(3):
                x = x @ w
        return x.sum()

    with FakeTensorMode():
        res = analyze(f, torch.empty(N, N), torch.empty(4, N))
    assert res["flops"] == 2 * 4 * N * N * 12


def test_bytes_convention():
    x, w = torch.randn(8, 16), torch.randn(16, 32)
    assert analyze(lambda t: t.view(16, 8).t().transpose(0, 1)[2:5], x)["bytes"] == 0
    # a matmul: both operands and its result
    assert analyze(lambda a, b: a @ b, x, w)["bytes"] == 4 * (8 * 16 + 16 * 32 + 8 * 32)
    # an elementwise op: its result only
    assert analyze(lambda a: a * 2.0, x)["bytes"] == 4 * 8 * 16

    def slice_write(buf, upd):
        buf[:, 4:6] = upd
        return buf

    assert analyze(slice_write, x, torch.randn(8, 2))["bytes"] == 4 * 8 * 2   # the payload
    idx = torch.tensor([1, 5])

    def index_write(buf, upd):
        buf[idx] = upd
        return buf

    # the payload and its indices, not the buffer
    assert analyze(index_write, x, torch.randn(2, 16))["bytes"] == 4 * 2 * 16 + 8 * 2


def test_transcendental_count():
    x = torch.randn(10, 12)
    assert analyze(lambda t: torch.exp(t) + torch.log(t.abs()), x)["transcendental"] == 240
    assert analyze(lambda t: torch.softmax(t, dim=-1), x)["transcendental"] == 120
    assert analyze(lambda t: t.pow(2) * torch.sin(t), x)["transcendental"] == 240
    assert analyze(lambda t: t * 2.0 + 1.0, x)["transcendental"] == 0


def test_memory_figures():
    """Arguments, the peak's temp, the outputs and the donated arguments."""
    def f(a, b):
        t = a * 2.0                 # 400 bytes, freed before the end
        u = t + 1.0                 # 400 more at the peak (a, b, t, u live)
        del t
        b.add_(u)
        return u.sum()

    a, b = torch.randn(10, 10), torch.randn(10, 10)
    res = analyze(f, a, b, donate=[b])
    assert res["argument_size_in_bytes"] == 800
    assert res["temp_size_in_bytes"] == 800
    assert res["output_size_in_bytes"] == 4
    assert res["alias_size_in_bytes"] == 400


COLLECTIVES_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import start_fake_world

    start_fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 16), mesh, (Shard(0), Replicate()))
        p = DTensor.from_local(torch.empty(8, 16), mesh, (Replicate(), Partial()))
        res = analyze(lambda x, p: (x.redistribute(mesh, (Replicate(), Replicate())),
                                    p.redistribute(mesh, (Replicate(), Replicate())),
                                    p.redistribute(mesh, (Replicate(), Shard(0)))), x, p)
    json.dump({k: res[k] for k in ("collectives", "collective_counts", "collective_bytes",
                                   "flops")}, sys.stdout)
""")


def test_collectives_on_a_fake_mesh():
    """Shard(0) -> Replicate: one all-gather of the (8, 16) f32 result;
    Partial -> Replicate over "model": one all-reduce of (8, 16); Partial
    -> Shard(0): one reduce-scatter to a (4, 16) shard."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", COLLECTIVES_SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout)
    assert res["collective_counts"] == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1}
    assert res["collectives"] == {"all-gather": 512.0, "all-reduce": 512.0,
                                  "reduce-scatter": 256.0}
    assert res["collective_bytes"] == 1280.0 and res["flops"] == 0.0


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_flash_attention_fake_route(dt):
    """K6 forward and backward on fake CUDA tensors: the work is the shared
    formula (the visible pairs of a causal mask with a q_offset), out and
    lse (and the backward's gradients and delta) are all it allocates, and
    no launch is counted."""
    B, S, T, H, KV, D, off = 2, 64, 96, 8, 2, 64, 32
    ops.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(B, S, H, D, dtype=dt, device="cuda")
        k, v = (torch.empty(B, T, KV, D, dtype=dt, device="cuda") for _ in range(2))
        res = analyze(lambda: flash_k.forward(q, k, v, True, None, None, 0.125, with_lse=True,
                                              q_offset=off))
        out, lse = res["result"]
        dout = torch.empty_like(out)
        bwd = analyze(flash_k.backward, q, k, v, out, lse, dout, True, None, None, 0.125,
                      q_offset=off)
    assert build.is_fake(out) and out.shape == q.shape and lse.shape == (B, H, S)
    e = q.element_size()
    want = flash_k.forward_work(B, S, T, H, KV, D, e, q_offset=off, with_lse=True)
    pairs = B * H * sum(min(T, s + off + 1) for s in range(S))
    assert want["flops"] == 4 * D * pairs == res["flops"]
    assert res["kernel_launches"] == {"flash_attention": 1}
    assert res["temp_size_in_bytes"] == q.numel() * e + 4 * B * H * S
    assert bwd["flops"] == flash_k.backward_work(B, S, T, H, KV, D, e, q_offset=off)["flops"] \
        == 10 * D * pairs
    # dq, dk, dv, delta
    assert bwd["peak_bytes"] - bwd["argument_size_in_bytes"] == \
        (q.numel() + 2 * k.numel()) * e + 4 * B * H * S
    assert all(n == 0 for n in ops.launch_counts().values())


def test_decode_attention_fake_route():
    """K7 with lse on fake CUDA tensors: 4 H D FLOPs a (slot, head) over
    every slot (a fake kv_len has no values: full rows), out, lse and the
    split scratch of its plan allocated, nothing launched."""
    B, T, H, KV, D = 4, 1000, 16, 8, 128
    ops.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(B, H, D, device="cuda")
        k, v = (torch.empty(B, T, KV, D, dtype=torch.bfloat16, device="cuda") for _ in range(2))
        lens = torch.empty(B, dtype=torch.int32, device="cuda")
        res = analyze(decode_k.decode_attention, q, k, v, lens, return_lse=True)
    out, lse = res["result"]
    assert out.dtype == torch.float32 and lse.shape == (B, H)
    assert res["flops"] == 4 * H * D * B * T == decode_k.work(B, H, KV, D, B * T, 4, 2, True)["flops"]
    plan = decode_k.split_plan(B, KV, T, H // KV, D, 2)
    scratch = 4 * B * KV * plan["n_split"] * (H // KV) * (2 + D)
    assert res["peak_bytes"] - res["argument_size_in_bytes"] == 4 * B * H * D + 4 * B * H + scratch
    assert res["temp_size_in_bytes"] == res["peak_bytes"] - res["argument_size_in_bytes"]
    assert all(n == 0 for n in ops.launch_counts().values())


def test_real_cpu_tensors_take_the_plain_version():
    """A real tensor never takes the fake route: on the CPU the wrappers run
    the plain versions, record no kernel work, and give their values."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g) for s in ((2, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    lens = torch.tensor([24, 5], dtype=torch.int32)
    assert not build.is_fake(q, k, v, lens)
    res = analyze(decode_k.decode_attention, q, k, v, lens, return_lse=True)
    assert res["kernel_launches"] == {}
    want = ref.decode_attention_ref(q, k, v, lens, return_lse=True)
    for got, w in zip(res["result"], want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    qf = torch.randn(2, 8, 4, 16, generator=g)
    res = analyze(flash_k.flash_attention, qf, qf[:, :, :2], qf[:, :, 2:])
    assert res["kernel_launches"] == {}
    torch.testing.assert_close(res["result"], ref.flash_attention_ref(qf, qf[:, :, :2],
                                                                       qf[:, :, 2:]))
