"""The port's plain K5/K6/K7 against the JAX package, on the CPU.

On the CPU the wrappers run the kernels' plain versions (``kernels/ref.py``);
they are held against the Pallas kernels in interpret mode (through
``repro.kernels.ops``, as tests/test_kernels.py runs them) and against the
JAX oracles in ``repro.kernels.ref``, with the JAX tests' own tolerances:
2e-5 in float32 and 2e-2 in bfloat16 for attention; 1e-5 (float32) and
2e-2 (bfloat16) for the ``sim_top1`` values, ids equal in float32.  The CUDA
kernels themselves are held against these plain versions in
test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import attn_core as j_attn_core
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import _scale, attn_core

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(*shape, dtype="float32"):
    """One seeded array as (jax, torch), both rounded to ``dtype`` alike."""
    x = RNG.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


class _Cfg:
    attn_logit_softcap = None
    query_pre_attn_scalar = None


# ------------------------------------------------------------ flash attention
class TestFlashAttentionPlain:
    @pytest.mark.parametrize("B,S,H,KV,D", [
        (1, 32, 4, 4, 32),     # MHA
        (2, 64, 8, 2, 64),     # GQA
        (1, 128, 8, 1, 128),   # MQA
        (2, 48, 4, 4, 16),     # odd seq vs block
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal_matches_pallas_and_oracle(self, B, S, H, KV, D, dtype):
        (jq, tq), (jk, tk), (jv, tv) = (_pair(B, S, H, D, dtype=dtype),
                                        _pair(B, S, KV, D, dtype=dtype),
                                        _pair(B, S, KV, D, dtype=dtype))
        got = ops.flash_attention(tq, tk, tv)
        assert got.dtype == tq.dtype and got.shape == (B, S, H, D)
        tol = _tol(dtype)
        np.testing.assert_allclose(
            _np(got), _np(jops.flash_attention(jq, jk, jv, block_q=16, block_k=16)), atol=tol)
        np.testing.assert_allclose(_np(got), _np(jref.flash_attention_ref(jq, jk, jv)), atol=tol)

    @pytest.mark.parametrize("kwargs", [
        {"causal": False},
        {"causal": True, "window": 16},
        {"causal": True, "softcap": 50.0},
        {"causal": True, "window": 24, "softcap": 30.0},
        {"causal": True, "scale": 0.0625},
    ])
    def test_variants(self, kwargs):
        (jq, tq), (jk, tk), (jv, tv) = _pair(2, 64, 8, 32), _pair(2, 64, 4, 32), _pair(2, 64, 4, 32)
        got = _np(ops.flash_attention(tq, tk, tv, **kwargs))
        np.testing.assert_allclose(
            got, _np(jops.flash_attention(jq, jk, jv, block_q=16, block_k=16, **kwargs)),
            atol=2e-5)
        np.testing.assert_allclose(got, _np(jref.flash_attention_ref(jq, jk, jv, **kwargs)),
                                   atol=2e-5)

    @pytest.mark.parametrize("D", [96, 112])
    @pytest.mark.parametrize("S,T,H,KV,kwargs", [
        (32, 32, 8, 8, {}),                       # zamba2 / phi-3-vision: MHA
        (32, 48, 4, 2, {"causal": False}),        # cross-attention, S != T
        (48, 32, 8, 4, {"causal": False}),
        (32, 32, 4, 4, {"window": 16, "softcap": 30.0}),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_padded_head_widths_match_pallas(self, D, S, T, H, KV, kwargs, dtype):
        """K6's plain version at the head widths the kernel pads to 128
        columns (zamba2's 112, phi-3-vision's 96), at multiples of the
        Pallas blocks, where the reference kernel is sound."""
        (jq, tq), (jk, tk), (jv, tv) = (_pair(2, S, H, D, dtype=dtype),
                                        _pair(2, T, KV, D, dtype=dtype),
                                        _pair(2, T, KV, D, dtype=dtype))
        got = ops.flash_attention(tq, tk, tv, **kwargs)
        assert got.shape == (2, S, H, D)
        tol = _tol(dtype)
        np.testing.assert_allclose(
            _np(got), _np(jops.flash_attention(jq, jk, jv, block_q=16, block_k=16, **kwargs)),
            atol=tol)
        np.testing.assert_allclose(_np(got), _np(jref.flash_attention_ref(jq, jk, jv, **kwargs)),
                                   atol=tol)

    @pytest.mark.parametrize("H,KV,kwargs", [
        (8, 1, {}),                                                 # gemma-2b: MQA, G = 8
        (4, 2, {"window": 32, "softcap": 50.0, "scale": 256 ** -0.5}),   # gemma2-9b: G = 2
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_head_width_256_matches_pallas(self, H, KV, kwargs, dtype):
        """K6's plain version at gemma's head width 256 (the width whose
        bf16 kernel takes two full-width warpgroups), at a multiple of the
        Pallas blocks, where the reference kernel is sound."""
        S, D = 64, 256
        (jq, tq), (jk, tk), (jv, tv) = (_pair(2, S, H, D, dtype=dtype),
                                        _pair(2, S, KV, D, dtype=dtype),
                                        _pair(2, S, KV, D, dtype=dtype))
        got = ops.flash_attention(tq, tk, tv, **kwargs)
        assert got.dtype == tq.dtype and got.shape == (2, S, H, D)
        tol = _tol(dtype)
        np.testing.assert_allclose(
            _np(got), _np(jops.flash_attention(jq, jk, jv, block_q=16, block_k=16, **kwargs)),
            atol=tol)
        np.testing.assert_allclose(_np(got), _np(jref.flash_attention_ref(jq, jk, jv, **kwargs)),
                                   atol=tol)

    def test_cross_attention_other_length(self):
        (jq, tq), (jk, tk), (jv, tv) = _pair(2, 32, 4, 32), _pair(2, 48, 2, 32), _pair(2, 48, 2, 32)
        np.testing.assert_allclose(
            _np(ops.flash_attention(tq, tk, tv, causal=False)),
            _np(jops.flash_attention(jq, jk, jv, causal=False, block_q=16, block_k=16)),
            atol=2e-5)

    def test_fully_masked_rows_give_zero_as_the_kernel(self):
        """Rows past the last key of a short window see no key: the TPU
        kernel (and the port) give 0 through the 1e-30 clamp, not NaN."""
        (jq, tq), (jk, tk), (jv, tv) = _pair(1, 48, 4, 32), _pair(1, 16, 4, 32), _pair(1, 16, 4, 32)
        got = _np(ops.flash_attention(tq, tk, tv, window=8))
        assert np.isfinite(got).all() and (got[:, 23:] == 0).all()
        np.testing.assert_allclose(
            got, _np(jops.flash_attention(jq, jk, jv, window=8, block_q=16, block_k=16)),
            atol=2e-5)

    def test_matches_model_attention_math(self):
        """Plain kernel == the models' plain attention path, in both packages."""
        (jq, tq), (jk, tk), (jv, tv) = _pair(2, 32, 8, 32), _pair(2, 32, 4, 32), _pair(2, 32, 4, 32)
        got = _np(ops.flash_attention(tq, tk, tv))
        np.testing.assert_allclose(got, _np(attn_core(tq, tk, tv, cfg=_Cfg(), causal=True)),
                                   atol=2e-5)
        np.testing.assert_allclose(got, _np(j_attn_core(jq, jk, jv, cfg=_Cfg(), causal=True)),
                                   atol=2e-5)

    @pytest.mark.parametrize("softcap,qscalar,window,causal", [
        (1.0, None, None, True), (None, 256.0, None, True), (None, None, 12, True),
        (2.0, 64.0, 12, True), (None, None, None, False),
    ])
    def test_model_arguments_reach_the_kernel_route(self, softcap, qscalar, window, causal):
        """The model's softcap, query_pre_attn_scalar and window, passed to
        the kernel op as ``models.attention`` passes them, give the models'
        plain attention in both packages."""
        class Cfg:
            attn_logit_softcap = softcap
            query_pre_attn_scalar = qscalar

        (jq, tq), (jk, tk), (jv, tv) = _pair(2, 40, 8, 16), _pair(2, 40, 2, 16), _pair(2, 40, 2, 16)
        got = _np(ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                      softcap=softcap, scale=_scale(Cfg, 16)))
        np.testing.assert_allclose(
            got, _np(attn_core(tq, tk, tv, cfg=Cfg, causal=causal, window=window)), atol=2e-5)
        np.testing.assert_allclose(
            got, _np(j_attn_core(jq, jk, jv, cfg=Cfg, causal=causal, window=window)), atol=2e-5)

    @pytest.mark.parametrize("softcap,qscalar", [(None, None), (1.0, 256.0)])
    def test_decode_route_matches_model_attention_math(self, softcap, qscalar):
        """``ops.decode_attention`` with ``kv_len`` == the models' plain
        attention of one query at its position over a masked cache."""
        class Cfg:
            attn_logit_softcap = softcap
            query_pre_attn_scalar = qscalar

        B, T = 3, 24
        (jq, tq), (jk, tk), (jv, tv) = _pair(B, 1, 8, 16), _pair(B, T, 2, 16), _pair(B, T, 2, 16)
        lens = np.array([1, 13, T], np.int32)
        pos = lens.astype(np.int64)[:, None] - 1
        got = _np(ops.decode_attention(tq[:, 0], tk, tv, torch.from_numpy(lens),
                                       softcap=softcap, scale=_scale(Cfg, 16)))
        want = attn_core(tq, tk, tv, cfg=Cfg, causal=False, q_positions=torch.from_numpy(pos),
                         kv_len=torch.from_numpy(lens))
        np.testing.assert_allclose(got, _np(want)[:, 0], atol=2e-5)
        jwant = j_attn_core(jq, jk, jv, cfg=Cfg, causal=False, q_positions=jnp.asarray(pos),
                            kv_len=jnp.asarray(lens))
        np.testing.assert_allclose(got, _np(jwant)[:, 0], atol=2e-5)


# ----------------------------------------------------------- decode attention
class TestDecodeAttentionPlain:
    @pytest.mark.parametrize("B,T,H,KV,D", [
        (1, 64, 4, 4, 32), (2, 96, 8, 2, 64), (4, 128, 8, 1, 128),
        (2, 64, 4, 4, 96), (2, 96, 8, 8, 112),    # phi-3-vision's and zamba2's heads
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_and_oracle(self, B, T, H, KV, D, dtype):
        (jq, tq), (jk, tk), (jv, tv) = (_pair(B, H, D, dtype=dtype),
                                        _pair(B, T, KV, D, dtype=dtype),
                                        _pair(B, T, KV, D, dtype=dtype))
        lens = RNG.integers(1, T + 1, B).astype(np.int32)
        lens[0] = 1
        got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
        assert got.dtype == tq.dtype and got.shape == (B, H, D)
        tol = _tol(dtype)
        jl = jnp.asarray(lens)
        np.testing.assert_allclose(
            _np(got), _np(jops.decode_attention(jq, jk, jv, jl, block_k=32)), atol=tol)
        np.testing.assert_allclose(_np(got), _np(jref.decode_attention_ref(jq, jk, jv, jl)),
                                   atol=tol)

    @pytest.mark.parametrize("T,H,KV,kwargs", [
        (128, 8, 1, {}),                                          # gemma-2b: MQA, G = 8
        (96, 4, 2, {"softcap": 50.0, "scale": 256 ** -0.5}),      # gemma2-9b: G = 2
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_head_width_256_matches_pallas(self, T, H, KV, kwargs, dtype):
        """K7's plain version at head width 256 (the width whose kernel takes
        byte-sized splits and merges them in the last block), kv_len at 1,
        a bf16 split's least 32 slots, 64, a ragged value and T."""
        D = 256
        lens = np.array([1, 32, 64, T - 29, T], np.int32)
        B = lens.size
        (jq, tq), (jk, tk), (jv, tv) = (_pair(B, H, D, dtype=dtype),
                                        _pair(B, T, KV, D, dtype=dtype),
                                        _pair(B, T, KV, D, dtype=dtype))
        got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens), **kwargs)
        assert got.dtype == tq.dtype and got.shape == (B, H, D)
        tol = _tol(dtype)
        jl = jnp.asarray(lens)
        np.testing.assert_allclose(
            _np(got), _np(jops.decode_attention(jq, jk, jv, jl, block_k=32, **kwargs)),
            atol=tol)
        np.testing.assert_allclose(
            _np(got), _np(jref.decode_attention_ref(jq, jk, jv, jl, **kwargs)), atol=tol)

    def test_softcap_and_scale(self):
        (jq, tq), (jk, tk), (jv, tv) = _pair(2, 8, 32), _pair(2, 80, 2, 32), _pair(2, 80, 2, 32)
        lens = np.array([80, 33], np.int32)
        got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens), softcap=30.0, scale=0.1)
        want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), softcap=30.0, scale=0.1,
                                     block_k=16)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)

    def test_full_cache_equals_flash_last_row(self):
        B, S, H, KV, D = 1, 48, 4, 2, 32
        (_, q), (_, k), (_, v) = _pair(B, S, H, D), _pair(B, S, KV, D), _pair(B, S, KV, D)
        full = ops.flash_attention(q, k, v)
        got = ops.decode_attention(q[:, -1], k, v, torch.tensor([S], dtype=torch.int32))
        np.testing.assert_allclose(_np(got), _np(full[:, -1]), atol=2e-5)

    def test_empty_row_gives_zero(self):
        (jq, tq), (jk, tk), (jv, tv) = _pair(2, 4, 16), _pair(2, 32, 2, 16), _pair(2, 32, 2, 16)
        lens = np.array([0, 5], np.int32)
        got = _np(ops.decode_attention(tq, tk, tv, torch.from_numpy(lens)))
        assert (got[0] == 0).all()
        np.testing.assert_allclose(
            got, _np(jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=16)),
            atol=2e-5)


# ------------------------------------------------------------------- sim_top1
def _unit_pair(*shape, dtype="float32"):
    x = RNG.standard_normal(shape).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


class TestSimTop1Plain:
    @pytest.mark.parametrize("Q,N,D", [(8, 64, 32), (128, 1000, 64),
                                       (5, 4096, 128), (64, 200, 256)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_and_oracle(self, Q, N, D, dtype):
        (jq, tq), (js, ts) = _unit_pair(Q, D, dtype=dtype), _unit_pair(N, D, dtype=dtype)
        val, idx = ops.nearest_neighbor(tq, ts)
        assert val.dtype == torch.float32 and idx.dtype == torch.int32
        tol = 1e-5 if dtype == "float32" else 2e-2
        for wv, wi in (jops.nearest_neighbor(jq, js), jref.sim_top1_ref(jq, js)):
            np.testing.assert_allclose(val.numpy(), _np(wv), atol=tol)
            if dtype == "float32":
                assert (idx.numpy() == np.asarray(wi)).all()

    def test_n_valid_masking(self):
        (jq, tq), (js, ts) = _unit_pair(16, 64), _unit_pair(512, 64)
        val, idx = ops.nearest_neighbor(tq, ts, n_valid=100)
        assert (idx.numpy() < 100).all()
        for wv, wi in (jops.nearest_neighbor(jq, js, n_valid=jnp.int32(100)),
                       jref.sim_top1_ref(jq, js, valid_n=100)):
            assert (idx.numpy() == np.asarray(wi)).all()
            np.testing.assert_allclose(val.numpy(), _np(wv), atol=1e-5)

    def test_ties_go_to_the_first_index_across_chunks(self):
        (_, q), (_, s) = _unit_pair(4, 32), _unit_pair(300, 32)
        s[250] = s[7]
        q[0] = s[7]
        val, idx = ref.sim_top1_ref(q, s, chunk=64)      # 7 and 250 in other chunks
        assert idx[0].item() == 7
        whole = ref.sim_top1_ref(q, s, chunk=1 << 20)
        assert torch.equal(idx, whole[1]) and torch.allclose(val, whole[0])

    def test_nothing_valid(self):
        (_, q), (_, s) = _unit_pair(3, 16), _unit_pair(10, 16)
        val, idx = ops.nearest_neighbor(q, s, n_valid=0)
        assert torch.isinf(val).all() and (idx == 0).all()
