// The backward of GQA prefill attention (K6's gradient), for Hopper (sm_90a).
//
// The reference has no Pallas backward: it differentiates the same attention
// math (repro/models/attention.py::attn_core; blocked_attention has the math
// of the Pallas kernel repro/kernels/flash_attention.py::flash_attention)
// with jax.grad.  The port's forward is K6 (csrc/flash_attention.cu), so the
// gradient is computed here from what K6's forward keeps: q, k, v, out and
// the per-row log-sum-exp lse ((B, H, S) fp32; +inf for a row that sees no
// key, whose p are then all 0).
//
//   P     = exp(softcap(scale q.k) - lse)            0 where masked
//   delta = rowsum(dO * O)                           delta_kernel
//   dV    = P^T dO,   dK = scale dS^T Q               dK/dV kernel
//   dS    = P * (dP - delta) * (1 - tanh^2(scale q.k / softcap)),  dP = dO V^T
//   dQ    = scale dS K                                dQ kernel
//
// The masks are the forward's: causal t <= s + q_offset, window t > s +
// q_offset - window, t < T (q_offset, the absolute position of q's row 0, is
// 0 for a whole prompt).
//
// Deterministic, without atomics: a dK/dV block owns keys of one kv head and
// batch and loops over every query row that may see them, for all G query
// heads of the kv head (row = position * G + head, the forward's rows), so
// the GQA sum is made inside the block; a dQ block owns rows of one kv head
// and batch and loops over the key tiles they may see.  Every output
// element is summed by one thread in a fixed order.
//
// What bounds it: at qwen3-1.7b's training shape (B=4, S=2048, H=16, KV=8,
// D=128, causal) the five products over the causal half (S, dP, dV, dK, dQ)
// are 172 GFLOP: 0.174 ms at the tensor cores' bf16 peak on an H100 SXM
// (700 W), 2.6 ms at the CUDA cores' fp32 peak.
//
// Two routes, chosen by the wrapper (kernels/flash_attention.py::
// bwd_launch_plan) and dispatched explicitly here:
//
//   * bf16 at every width -> dkdv_tc_kernel and
//     dq_tc_kernel, on the tensor cores (wgmma + TMA; the PTX wrappers are
//     hopper.cuh's, shared with the forward).  A block has two consumer
//     warpgroups and a producer warpgroup whose one warp keeps TMA loads in
//     flight through mbarriers (setmaxnreg 40 / 232, as the forward).
//     dK/dV: a block per (64 keys, kv head, b), K and V loaded once; it
//     walks the rows that may see its keys 64 rows (P = 64 / G positions)
//     at a time through a two-stage ring of Q and dO tiles (a TMA box of
//     (chunk, G, P, 1): the forward's row packing), and the producer warp
//     gathers each tile's lse and delta into shared memory (the rows
//     interleave G heads, so in (B, H, S) they are not contiguous).
//     Everything runs transposed, keys on the wgmma M axis, so P and dS
//     never leave registers: S^T = K Q^T and dP^T = V dO^T are shared x
//     shared wgmmas (both K-major), P^T and dS^T are computed in fp32
//     registers (base 2, ex2.approx), dV += P^T dO and dK += dS^T Q are
//     register-A wgmmas reading dO and Q MN-major from the same ring tiles.
//     The first warpgroup makes dV, the second dK: ptxas gives a thread of
//     a 384-thread block 168 registers whatever setmaxnreg asks for at run
//     time, and a warpgroup holding both 64 x D accumulators (128 registers
//     at D = 128) spilled and serialized its wgmmas (PERF.md, PR 21); split,
//     each fits without spills, for one more S^T pass.  Blocks of the
//     longest causal range start first.  Rows of a ring tile past P * G (G
//     not dividing 64) are zeroed once: they are the K axis of dV and dK.
//     dQ: a block per (128 rows, kv head, b), 64 rows a warpgroup, Q and dO
//     loaded once, K and V tiles through a two-stage ring; S = Q K^T and dP
//     = dO V^T shared x shared, dS in registers, dQ += dS K register-A with
//     K read MN-major.  dQ stays its own pass: fused into dK/dV it needs
//     atomics (not deterministic) or a partial buffer per key tile (on the
//     order of a gigabyte at the training shape).
//     P and dS are split as the forward splits P for P V: hi = bf16(x), lo =
//     bf16(x - hi), two register-A wgmmas into one fp32 accumulator, so they
//     keep about 16 bits.  One bf16 rounding each (what SDPA's and
//     FlashAttention-3's backwards do) misses the 2e-5 limit the backward is
//     held to: a CPU emulation at B=1, S=512, H=4, KV=2, D=128, causal, bf16
//     inputs, against an fp64 gradient, gave max error / max |value| of
//     (dq, dk, dv) 2.7e-3, 2.2e-3, 1.5e-3 with one bf16 (thousands of values
//     over the limit), 2.8e-6, 1.9e-6, 1.9e-6 with hi + lo (none), 2.8e-8,
//     2.9e-8, 3.7e-8 with fp32 P and dS (tests/
//     test_torch_attention_bwd_plan.py keeps the comparison).  S and dP take
//     bf16 inputs and are exact in fp32: no split.  So the two kernels issue
//     11 product passes where 5 are needed (S^T twice and dP^T in dK/dV, S
//     and dP in dQ, dV, dK and dQ twice each): 0.38 ms at the bf16 peak.
//     D = 96 and 112 take 128-column tiles whose columns past D read zeros,
//     as in the forward.
//     Measured at the training shape (chip_smoke.py phase train, NVIDIA H100
//     80GB HBM3, 700 W): the three kernels 0.762 ms of device time a call
//     (dK/dV 0.457, dQ 0.273, delta 0.029; 0.896 ms a wrapper call), 1.73x
//     SDPA's backward on the device (0.441 ms), where the CUDA-core route
//     took 10.8-11.0 ms a call; the passes run at 527 (dK/dV) and 504 (dQ)
//     TFLOP/s of the bf16 peak's 989.
//     D = 256 (gemma's heads): a warpgroup's accumulator covers one column
//     half (Cfg::kN = 128 columns), so every register budget is D = 128's.
//     A whole 64 x 256 fp32 accumulator is 128 of the 168 registers a
//     thread; with the S^T / dP^T fragments (64) and the hi/lo words (32)
//     it cannot fit, and one warpgroup a block (255 registers) would still
//     hold 224 live values beside its addresses, or need dV and dK in
//     separate blocks anyway.  So the dK/dV grid gains a column-half axis
//     (block x: key tile x / 2, half x % 2): each block makes dV and dK of
//     its 64 keys for 128 of the 256 columns, reading K, V, Q and dO whole
//     (S^T and dP^T contract over all of D, so they are computed once per
//     half), and the dV / dK products read the half's two 64-column chunks
//     of the ring tiles.  The dQ block keeps one 64-row Q / dO tile, which
//     both warpgroups share: each computes S and dP for it and makes one
//     column half of dQ (two resident tiles per warpgroup and a two-stage
//     K / V ring would be 256 KB of shared memory; this way it is 192 KB,
//     as dK/dV's).  Product passes in bf16-peak units of the five needed:
//     dK/dV 10 (S^T 2 + dV 1 in the dV warpgroup, S^T, dP^T and dK 3 in
//     the dK one, per half), dQ 6: 16 where D <= 128 issues 11.  At
//     gemma-2b's training shape (B=4, S=2048, H=8, KV=1: MQA, G = 8) the
//     halves also double the dK/dV grid from 128 blocks, fewer than the
//     132 SMs, to 256, each block walking its keys' rows of all 8 heads,
//     the longest causal range first within each batch.  Measured there
//     (chip_smoke.py --bwd-rows, NVIDIA H100 80GB HBM3, 700 W): 1.07-1.10
//     ms of device time a call, 157-160 TFLOP/s of the 5 products, against
//     SDPA's backward (cuDNN) 0.61 ms and the CUDA-core route's 16.3 ms.
//   * f32 at every width -> dkdv_kernel and dq_kernel, on the CUDA cores:
//     every product an fp32 FMA over fp32 tiles in shared memory (S and dP
//     are computed in both kernels: 7 products where 5 are needed).  A
//     tensor-core product at f32 would be TF32 and break the 2e-5 limit.
//
// CUDA-core layout: thread (ty, tx) of 16 x 16 owns A/16 entries of the
// tile's own axis (keys in dK/dV, query rows in dQ) and 4 of the 64 entries
// of the other axis (tx + 16 j).  Own-axis operands sit row-major in shared
// memory (float4 reads that a half-warp shares); other-axis operands are
// stored transposed with a stride of 65 words, so consecutive threads read
// consecutive words, and a read down a column (fixed other index, d = tx +
// 16 e) also falls on distinct banks.  q, k, v, out and dO are contiguous
// (the wrapper passes contiguous copies).
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "elem_io.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;     // 16 x 16
constexpr int kOther = 64;        // the other axis of a score tile: 4 a thread
constexpr int kTs = kOther + 1;   // row stride of a transposed tile [D][kTs]
constexpr int kPs = kOther + 4;   // row stride of a score tile [own][kPs]

// qo (q_offset): the absolute position of q's row 0.  The kernels address
// rows by their position s in q; the masks compare keys with s + qo.
struct Masks {
  int S, T, H, KV, G, causal, window, qo;
  float softcap, scale;
  __device__ __forceinline__ bool visible(int pos, int t) const {
    pos += qo;
    return t < T && (!causal || t <= pos) && (window <= 0 || t > pos - window);
  }
};

// p and dS of one score from its dot x = q.k and dp = dO.v (see the top).
__device__ __forceinline__ void grad_score(float x, float dp, float lse, float delta, bool ok,
                                           const Masks& mk, float& p, float& ds) {
  float y = x * mk.scale, dcap = 1.f;
  if (mk.softcap > 0.f) {
    const float th = tanhf(y / mk.softcap);
    y = mk.softcap * th;
    dcap = 1.f - th * th;
  }
  p = ok ? expf(y - lse) : 0.f;
  ds = p * (dp - delta) * dcap;
}

__device__ __forceinline__ float part(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Element offset of (b, position, head) in a contiguous (B, L, heads, D) tensor.
__device__ __forceinline__ long long at(int b, int L, int pos, int heads, int head, int D) {
  return ((static_cast<long long>(b) * L + pos) * heads + head) * D;
}

// Piece `piece` (kVec<float> values) of a row at src (16-byte aligned;
// nullptr: zeros) into dst[d * step].
__device__ __forceinline__ void load_piece(const float* src, int piece, float* dst, int step) {
  constexpr int V = kVec<float>;
  float x[V] = {};
  if (src != nullptr) load16(src + piece * V, x);
#pragma unroll
  for (int j = 0; j < V; ++j) dst[(piece * V + j) * step] = x[j];
}

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]: a warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int n_rows, int D, int S, int H) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;   // the whole warp
  const T* a = o + static_cast<long long>(row) * D;
  const T* c = dout + static_cast<long long>(row) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(a[d]), to_f(c[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {   // row = (b * S + s) * H + h
    const int h = row % H, bs = row / H, s = bs % S, b = bs / S;
    delta[(static_cast<long long>(b) * H + h) * S + s] = acc;
  }
}

template <int D, int BK>
constexpr size_t dkdv_smem() {
  // Ks, Vs [BK][D + 4]; Qt, dOt [D][kTs]; Ps, dSs [BK][kPs]; lse, delta [kOther]
  return sizeof(float) * (2 * BK * (D + 4) + 2 * D * kTs + 2 * BK * kPs + 2 * kOther);
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, Masks mk) {
  constexpr int KPT = BK / 16, E = D / 16, kKs = D + 4, DV = D / kVec<float>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [BK][kKs]
  float* Vs = Ks + BK * kKs;          // [BK][kKs]
  float* Qt = Vs + BK * kKs;          // [D][kTs]
  float* dOt = Qt + D * kTs;          // [D][kTs]
  float* Ps = dOt + D * kTs;          // [BK][kPs]
  float* dSs = Ps + BK * kPs;         // [BK][kPs]
  float* lse_s = dSs + BK * kPs;      // [kOther]
  float* delta_s = lse_s + kOther;    // [kOther]

  const int t0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int G = mk.G, S = mk.S;

  for (int i = tid; i < BK * DV; i += kThreads) {
    const int c = i / DV, t = t0 + c;
    const long long off = at(b, mk.T, t, mk.KV, kvh, D);
    load_piece(t < mk.T ? k + off : nullptr, i - c * DV, Ks + c * kKs, 1);
    load_piece(t < mk.T ? v + off : nullptr, i - c * DV, Vs + c * kKs, 1);
  }

  // the rows that may see a key of this tile (key t is seen from position
  // t - qo on, and up to t + window - 1 - qo)
  const int t_last = min(t0 + BK, mk.T) - 1;
  const int pos_lo = mk.causal ? max(0, t0 - mk.qo) : 0;
  const int pos_hi = mk.window > 0 ? min(S - 1, t_last + mk.window - 1 - mk.qo) : S - 1;
  const int r_begin = pos_lo * G, r_end = max(r_begin, (pos_hi + 1) * G);

  float acc_k[KPT][E], acc_v[KPT][E];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kOther) {
    __syncthreads();   // the previous rows' tiles are consumed
    for (int i = tid; i < kOther * DV; i += kThreads) {
      const int rr = i / DV, r = r0 + rr, pos = r / G;
      const long long off = at(b, S, pos, mk.H, kvh * G + r - pos * G, D);
      load_piece(r < r_end ? q + off : nullptr, i - rr * DV, Qt + rr, kTs);
      load_piece(r < r_end ? dout + off : nullptr, i - rr * DV, dOt + rr, kTs);
    }
    if (tid < kOther) {
      const int r = r0 + tid, pos = r / G;
      const long long row = (static_cast<long long>(b) * mk.H + kvh * G + r - pos * G) * S + pos;
      lse_s[tid] = r < r_end ? lse[row] : CUDART_INF_F;
      delta_s[tid] = r < r_end ? delta[row] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for keys ty * KPT + i, rows tx + 16 j
    float s[KPT][4], dp[KPT][4];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kk[KPT], vv[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        kk[i] = *reinterpret_cast<const float4*>(Ks + (ty * KPT + i) * kKs + d);
        vv[i] = *reinterpret_cast<const float4*>(Vs + (ty * KPT + i) * kKs + d);
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float qv[4], ov[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qt[(d + dd) * kTs + tx + 16 * j];
          ov[j] = dOt[(d + dd) * kTs + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const float a = part(kk[i], dd), c = part(vv[i], dd);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a, qv[j], s[i][j]);
            dp[i][j] = fmaf(c, ov[j], dp[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int t = t0 + ty * KPT + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = tx + 16 * j, r = r0 + rr;
        float p, ds;
        grad_score(s[i][j], dp[i][j], lse_s[rr], delta_s[rr],
                   r < r_end && mk.visible(r / G, t), mk, p, ds);
        Ps[(ty * KPT + i) * kPs + rr] = p;
        dSs[(ty * KPT + i) * kPs + rr] = ds;
      }
    }
    __syncthreads();

    // dV += P dO, dK += dS Q over the tile's rows; columns tx + 16 e
#pragma unroll 4
    for (int rr = 0; rr < kOther; ++rr) {
      float p[KPT], ds[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        p[i] = Ps[(ty * KPT + i) * kPs + rr];
        ds[i] = dSs[(ty * KPT + i) * kPs + rr];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float o = dOt[(tx + 16 * e) * kTs + rr], qq = Qt[(tx + 16 * e) * kTs + rr];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          acc_v[i][e] = fmaf(p[i], o, acc_v[i][e]);
          acc_k[i][e] = fmaf(ds[i], qq, acc_k[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int t = t0 + ty * KPT + i;
    if (t >= mk.T) continue;
    const long long off = at(b, mk.T, t, mk.KV, kvh, D);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      store(dk + off + tx + 16 * e, acc_k[i][e] * mk.scale);
      store(dv + off + tx + 16 * e, acc_v[i][e]);
    }
  }
}

template <int D, int BR>
constexpr size_t dq_smem() {
  // Qs, dOs [BR][D + 4]; Kt, Vt [D][kTs]; dSs [BR][kPs]
  return sizeof(float) * (2 * BR * (D + 4) + 2 * D * kTs + BR * kPs);
}

template <int D, int BR>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, Masks mk) {
  constexpr int RPT = BR / 16, E = D / 16, kQs = D + 4, DV = D / kVec<float>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [BR][kQs]
  float* dOs = Qs + BR * kQs;         // [BR][kQs]
  float* Kt = dOs + BR * kQs;         // [D][kTs]
  float* Vt = Kt + D * kTs;           // [D][kTs]
  float* dSs = Vt + D * kTs;          // [BR][kPs]

  const int r0 = blockIdx.x * BR, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int G = mk.G, S = mk.S, n_rows = S * G;

  for (int i = tid; i < BR * DV; i += kThreads) {
    const int rr = i / DV, r = r0 + rr, pos = r / G;
    const long long off = at(b, S, pos, mk.H, kvh * G + r - pos * G, D);
    load_piece(r < n_rows ? q + off : nullptr, i - rr * DV, Qs + rr * kQs, 1);
    load_piece(r < n_rows ? dout + off : nullptr, i - rr * DV, dOs + rr * kQs, 1);
  }
  int pos_r[RPT];
  float lse_r[RPT], delta_r[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty * RPT + i;
    pos_r[i] = r < n_rows ? r / G : -1;
    const long long row =
        (static_cast<long long>(b) * mk.H + kvh * G + r - (r / G) * G) * S + r / G;
    lse_r[i] = r < n_rows ? lse[row] : CUDART_INF_F;
    delta_r[i] = r < n_rows ? delta[row] : 0.f;
  }

  // the keys this block's rows may see (mask positions + qo)
  const int pos_lo = r0 / G + mk.qo, pos_hi = (min(r0 + BR, n_rows) - 1) / G + mk.qo;
  const int t_lo = mk.window > 0 ? max(0, pos_lo - mk.window + 1) : 0;
  const int t_hi = mk.causal ? min(mk.T, pos_hi + 1) : mk.T;

  float acc[RPT][E];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;

  for (int t0 = t_lo; t0 < t_hi; t0 += kOther) {
    __syncthreads();   // the previous key tile is consumed
    for (int i = tid; i < kOther * DV; i += kThreads) {
      const int c = i / DV, t = t0 + c;
      const long long off = at(b, mk.T, t, mk.KV, kvh, D);
      load_piece(t < mk.T ? k + off : nullptr, i - c * DV, Kt + c, kTs);
      load_piece(t < mk.T ? v + off : nullptr, i - c * DV, Vt + c, kTs);
    }
    __syncthreads();

    // S and dP for rows ty * RPT + i, keys tx + 16 j
    float s[RPT][4], dp[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qq[RPT], oo[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qq[i] = *reinterpret_cast<const float4*>(Qs + (ty * RPT + i) * kQs + d);
        oo[i] = *reinterpret_cast<const float4*>(dOs + (ty * RPT + i) * kQs + d);
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float kv[4], vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = Kt[(d + dd) * kTs + tx + 16 * j];
          vv[j] = Vt[(d + dd) * kTs + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = part(qq[i], dd), c = part(oo[i], dd);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a, kv[j], s[i][j]);
            dp[i][j] = fmaf(c, vv[j], dp[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        float p, ds;
        grad_score(s[i][j], dp[i][j], lse_r[i], delta_r[i],
                   pos_r[i] >= 0 && mk.visible(pos_r[i], t), mk, p, ds);
        dSs[(ty * RPT + i) * kPs + tx + 16 * j] = ds;
      }
    __syncthreads();

    // dQ += dS K; columns tx + 16 e
#pragma unroll 4
    for (int c = 0; c < kOther; ++c) {
      float ds[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) ds[i] = dSs[(ty * RPT + i) * kPs + c];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float kk = Kt[(tx + 16 * e) * kTs + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][e] = fmaf(ds[i], kk, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (pos_r[i] < 0) continue;
    const int r = r0 + ty * RPT + i;
    float* row = dq + at(b, S, pos_r[i], mk.H, kvh * G + r - pos_r[i] * G, D);
#pragma unroll
    for (int e = 0; e < E; ++e) store(row + tx + 16 * e, acc[i][e] * mk.scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B;
  Masks mk;
  cudaStream_t stream;
};

// ----------------------------------------------------------- bf16 route
namespace tc {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

// Shapes of the bf16 route at head width D.  The launch shape comes from
// kernels/flash_attention.py::bwd_launch_plan (the CPU tests check it
// there); `launch` refuses a plan that differs from these.  Both kernels
// keep resident tiles (dK/dV: the block's K and V; dQ: each warpgroup's Q
// and dO) and a ring of kStages pairs (dK/dV: Q and dO; dQ: K and V), every
// tile kTile rows (keys or (position, head) rows) of kDp bf16 columns,
// loaded as kNChunk TMA boxes of kChunk columns (D = 96, 112: kDp = 128,
// the last box runs past D and TMA fills it with zeros).
template <int D>
struct Cfg {
  static constexpr int kWG = 2;                       // consumer warpgroups
  static constexpr int kTile = 64;                    // rows of a tile
  static constexpr int kStages = 2;                   // ring depth
  static constexpr int kChunk = D < 64 ? D : 64;      // columns per TMA box
  static constexpr int kNChunk = (D + kChunk - 1) / kChunk;
  static constexpr int kDp = kNChunk * kChunk;        // smem tile width
  static constexpr int kRowBytes = kChunk * 2;        // = the swizzle width
  static constexpr int kTileBytes = kTile * kDp * 2;
  // a warpgroup's accumulator: kN columns, one of kHalves column halves
  // (D = 256: 128 of 256), of which it stores kOut (D = 96, 112: the first D)
  static constexpr int kN = kDp > 128 ? 128 : kDp;
  static constexpr int kHalves = kDp / kN;
  static constexpr int kOut = kHalves > 1 ? kN : D;
  static constexpr int kHalfOffset = kN / kChunk * kTile * kRowBytes;   // bytes in a tile
  // dQ: resident row tiles, one a warpgroup, or (kHalves = 2) one that both
  // warpgroups share, each making one column half of its dQ
  static constexpr int kQTiles = kHalves > 1 ? 1 : kWG;
  // consumer warpgroups, then one producer warpgroup; setmaxnreg moves the
  // producer's registers to the consumers
  static constexpr int kThreads = (kWG + 1) * 128;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  // dK/dV: K, V and the ring, each stage's row values (lse * log2 e,
  // delta), the tile rows' positions, 1 + 2 * kStages mbarriers
  static constexpr size_t kDkdvTiles = static_cast<size_t>(2 + 2 * kStages) * kTileBytes;
  static constexpr size_t kDkdvSmem =
      1024 + kDkdvTiles + (2 * kStages + 1) * kTile * 4 + 8 * (1 + 2 * kStages);
  // dQ: the resident Q and dO tiles and the ring, 1 + 2 * kStages mbarriers
  static constexpr size_t kDqTiles = static_cast<size_t>(2 * kQTiles + 2 * kStages) * kTileBytes;
  static constexpr size_t kDqSmem = 1024 + kDqTiles + 8 * (1 + 2 * kStages);
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "an H100 block's shared memory");
};

// p of one score (see the top) into x, and with kDs dS into dp; x = q.k
// and dp = dO.v from the products; lse2 = lse * log2 e (+inf: a row that
// sees no key, p = 0).
template <bool kCap, bool kDs>
__device__ __forceinline__ void p_ds(float& x, float& dp, float lse2, float delta, bool ok,
                                     const Masks& mk, float scale_log2) {
  float p, dcap = 1.f;
  if constexpr (kCap) {
    const float th = tanhf(x * mk.scale / mk.softcap);
    p = exp2_approx(mk.softcap * kLog2e * th - lse2);
    dcap = 1.f - th * th;
  } else {
    p = exp2_approx(fmaf(x, scale_log2, -lse2));
  }
  p = ok ? p : 0.f;
  x = p;
  if constexpr (kDs) dp = p * (dp - delta) * dcap;
}

// dK/dV: one tile of S^T, dP^T (keys x rows) -> P^T in sc, with kDs dS^T
// in dp.  sc[j*4 + i*2 + e] is (key key_r[i], tile row j*8 + col + e);
// that row's lse2 and delta come from the stage's row values, its position
// from row_pos.  kMasked: some pair of the tile may be masked (or a key is
// past T); a tile all of whose pairs are visible skips the per-element test.
template <int kT, bool kCap, bool kMasked, bool kDs>
__device__ __forceinline__ void grad_tile_keys(float* sc, float* dp, const float* lse2,
                                               const float* delta, const int* row_pos,
                                               const int* key_r, int p0, int col,
                                               const Masks& mk, float scale_log2) {
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + j * 8 + col);
    const float2 d2 = *reinterpret_cast<const float2*>(delta + j * 8 + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int pos = 0;
      if constexpr (kMasked) pos = p0 + row_pos[j * 8 + col + e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool ok = !kMasked || mk.visible(pos, key_r[i]);
        p_ds<kCap, kDs>(sc[j * 4 + i * 2 + e], dp[j * 4 + i * 2 + e], e ? l2.y : l2.x,
                        e ? d2.y : d2.x, ok, mk, scale_log2);
      }
    }
  }
}

// dQ: one tile of S, dP (rows x keys) -> dS in dp.  sc[j*4 + i*2 + e] is
// (row i: position pos_r[i], key t0 + j*8 + col + e).
template <int kT, bool kCap, bool kMasked>
__device__ __forceinline__ void grad_tile_rows(float* sc, float* dp, const float* lse2,
                                               const float* delta, const int* pos_r, int t0,
                                               int col, const Masks& mk, float scale_log2) {
#pragma unroll
  for (int j = 0; j < kT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool ok = !kMasked || mk.visible(pos_r[i], t0 + j * 8 + col + e);
        p_ds<kCap, true>(sc[j * 4 + i * 2 + e], dp[j * 4 + i * 2 + e], lse2[i], delta[i], ok,
                         mk, scale_log2);
      }
}

// Keep a register-A operand's words live until its wgmma has completed, so
// the compiler does not hand their registers to other values while the
// wgmma may still read them.
template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// acc += A B for the kT-deep register-A operand A = hi + lo (two wgmmas
// each k16 step) and B an MN-major tile of kT rows (its 64-column chunks
// kT * kRB bytes apart, 8-row groups 8 * kRB apart, a k16 step 16 rows),
// kN of its columns from `tile` on.
template <int kT, int kN, int kRB>
__device__ __forceinline__ void issue_split(float* acc, uint32_t (*hi)[4], uint32_t (*lo)[4],
                                            uint32_t tile) {
  const uint64_t bd = smem_desc(tile, kT * kRB, 8 * kRB, kRB);
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    wgmma_rs<kN>(acc, hi[kk], bd + ((kk * 16 * kRB) >> 4));
    wgmma_rs<kN>(acc, lo[kk], bd + ((kk * 16 * kRB) >> 4));
  }
}

// bf16 pairs of a thread's accumulator row i (columns j*8 + col, + 1; the
// first D of its kN) times `mul` to row.
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* row, const float* acc, int i,
                                          float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(row + j * 8) =
        __floats2bfloat162_rn(acc[j * 4 + i * 2] * mul, acc[j * 4 + i * 2 + 1] * mul);
}

// dK and dV of kTile keys of one kv head: a block per (key tile, kv head,
// b), walking the query rows (row = position * G + head) that may see its
// keys, P = box positions (P * G of a tile's kTile rows) at a time.  The
// first consumer warpgroup makes dV (S^T, P^T, dV += P^T dO), the second
// dK (S^T and dP^T, dS^T, dK += dS^T Q): each holds one kTile x kN
// accumulator, so both fit the 168 registers a thread ptxas allows a
// 384-thread block (one warpgroup holding both spills; setmaxnreg moves
// registers at run time, not in ptxas's allocation).  S^T is computed by
// both: 7 product passes for the pair, where one warpgroup would issue 6.
// With two column halves (D = 256) block x makes columns [128 h, 128 h +
// 128) of key tile x / 2's dV and dK, h = x % 2.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, Masks mk, int P) {
  using C = Cfg<D>;
  static_assert(C::kWG == 2, "one warpgroup for dV, one for dK");
  constexpr int kNS = C::kStages, kRB = C::kRowBytes, kT = C::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms
  uint8_t* gbase = smem_raw + (base - raw);       // the same bytes, generic
  const uint32_t sK = base;                       // resident
  const uint32_t sV = sK + C::kTileBytes;
  const uint32_t sQ = sV + C::kTileBytes;         // [kNS] ring
  const uint32_t sdO = sQ + kNS * C::kTileBytes;
  float* row_vals = reinterpret_cast<float*>(gbase + C::kDkdvTiles);   // [kNS][2][kT]
  int* row_pos = reinterpret_cast<int*>(row_vals + kNS * 2 * kT);      // [kT]
  const uint32_t bars =
      base + static_cast<uint32_t>(C::kDkdvTiles) + (kNS * 2 + 1) * kT * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kNS + s); };

  const int G = mk.G, S = mk.S, rows = G * P;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int half = blockIdx.x % C::kHalves;                  // the column half
  const int t0 = blockIdx.x / C::kHalves * kT;   // causal: tile 0 has the longest range
  const int t_last = min(t0 + kT, mk.T) - 1;
  // positions that may see a key of the block (key t is seen from position
  // t - qo on, and up to t + window - 1 - qo)
  const int pos_lo = mk.causal ? max(0, t0 - mk.qo) : 0;
  const int pos_hi = mk.window > 0 ? min(S - 1, t_last + mk.window - 1 - mk.qo) : S - 1;
  const int n_tiles = pos_hi >= pos_lo ? (pos_hi - pos_lo + P) / P : 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // rows [rows, kT) of every ring tile stay 0 (TMA writes only a box's rows):
  // they are the K axis of dV and dK
  if (rows < kT) {
    constexpr int kPerRow = kRB / 16;
    const int per_chunk = (kT - rows) * kPerRow;
    for (int i = tid; i < 2 * kNS * C::kNChunk * per_chunk; i += C::kThreads) {
      const int t = i / (C::kNChunk * per_chunk), r = i - t * C::kNChunk * per_chunk;
      const int c = r / per_chunk, w = r - c * per_chunk;
      *reinterpret_cast<uint4*>(gbase + (sQ - base) + t * C::kTileBytes + c * kT * kRB +
                                rows * kRB + w * 16) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid < kT) row_pos[tid] = tid / G;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kNS; ++s) {
      mbar_init(full(s), 32);            // the producer warp: TMA bytes and row values
      mbar_init(empty(s), C::kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::kWG * 4) {
    // ---- producer: K and V once, then Q, dO tiles and their rows' lse and
    // delta (in (B, H, S) the tile's rows interleave G heads) through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (warp == C::kWG * 4) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::kTileBytes);
        for (int c = 0; c < C::kNChunk; ++c) {
          tma_load_4d(sK + c * kT * kRB, &kmap, kv_full, c * C::kChunk, kvh, t0, b);
          tma_load_4d(sV + c * kT * kRB, &vmap, kv_full, c * C::kChunk, kvh, t0, b);
        }
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kNS;
        const uint32_t ph = (n / kNS) & 1;
        const int p0 = pos_lo + n * P;
        mbar_wait(empty(s), ph ^ 1);
        if (lane == 0) {
          mbar_add_tx(full(s), 2 * C::kNChunk * rows * kRB);
          for (int c = 0; c < C::kNChunk; ++c) {
            const uint32_t off = s * C::kTileBytes + c * kT * kRB;
            tma_load_4d(sQ + off, &qmap, full(s), c * C::kChunk, kvh * G, p0, b);
            tma_load_4d(sdO + off, &domap, full(s), c * C::kChunk, kvh * G, p0, b);
          }
        }
        float* l2 = row_vals + s * 2 * kT;
        for (int rr = lane; rr < kT; rr += 32) {
          const int pos = p0 + rr / G;
          const bool ok = rr < rows && pos < S;
          const long long row = (static_cast<long long>(b) * mk.H + kvh * G + rr % G) * S + pos;
          l2[rr] = ok ? lse[row] * kLog2e : CUDART_INF_F;
          l2[kT + rr] = ok ? delta[row] : 0.f;
        }
        mbar_arrive(full(s));   // each lane once its row values are written
      }
    }
    return;
  }

  // ---- consumers: warpgroup 0 makes dV, warpgroup 1 dK, of keys [t0, t0 + kT)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int w4 = warp & 3;
  int key_r[2];                                     // this thread's accumulator rows
#pragma unroll
  for (int i = 0; i < 2; ++i) key_r[i] = t0 + w4 * 16 + (lane >> 2) + 8 * i;
  const int col = (lane & 3) * 2;
  const float scale_log2 = mk.scale * kLog2e;
  mbar_wait(kv_full, 0);

  // one warpgroup's loop and store; kDk is a compile-time constant, so no
  // wgmma sits in a branch the compiler must treat as divergent
  auto consume = [&](auto dk_tag) {
    constexpr bool kDk = decltype(dk_tag)::value;
    constexpr int kN = C::kN;
    float acc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kNS;
      const uint32_t ph = (n / kNS) & 1;
      const int p0 = pos_lo + n * P, p_last = min(S - 1, p0 + P - 1);
      const int m0 = p0 + mk.qo, m_last = p_last + mk.qo;   // mask positions
      mbar_wait(full(s), ph);
      // some pair of the block's keys and the tile's positions visible?
      const bool any =
          (!mk.causal || m_last >= t0) && (mk.window <= 0 || t_last > m0 - mk.window);
      if (any) {
        const uint32_t sQs = sQ + s * C::kTileBytes, sdOs = sdO + s * C::kTileBytes;
        const float* l2 = row_vals + s * 2 * kT;
        const bool whole = t_last == t0 + kT - 1 && (!mk.causal || m0 >= t_last) &&
                           (mk.window <= 0 || t0 > m_last - mk.window);
        float sc[kT / 2], dp[kT / 2];
        uint32_t hi[kT / 16][4], lo[kT / 16][4];
        // S^T = K Q^T (and dP^T = V dO^T): both operands K-major
        wgmma_fence();
        issue_s<D, kT, kRB>(sc, sK, sQs);
        if constexpr (kDk) issue_s<D, kT, kRB>(dp, sV, sdOs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kT / 2>(sc);
        if constexpr (kDk) fence_regs<kT / 2>(dp);
#define GRAD_TILE(cap, masked)                                                           \
  grad_tile_keys<kT, cap, masked, kDk>(sc, dp, l2, l2 + kT, row_pos, key_r, p0, col, mk, \
                                       scale_log2)
        if (mk.softcap > 0.f) {
          if (whole) GRAD_TILE(true, false);
          else GRAD_TILE(true, true);
        } else {
          if (whole) GRAD_TILE(false, false);
          else GRAD_TILE(false, true);
        }
#undef GRAD_TILE
        // dV += P^T dO, dK += dS^T Q: the half's columns of dO and Q read
        // MN-major from the ring tiles
        if constexpr (kDk) split_p<kT>(dp, hi, lo);
        else split_p<kT>(sc, hi, lo);
        fence_regs<kN / 2>(acc);
        wgmma_fence();
        issue_split<kT, kN, kRB>(acc, hi, lo, (kDk ? sQs : sdOs) + half * C::kHalfOffset);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kN / 2>(acc);
        fence_u32<kT / 16>(hi);
        fence_u32<kT / 16>(lo);
      }
      mbar_arrive(empty(s));
    }
    // dk, dv (B, T, KV, D) contiguous; dK carries the scale
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key_r[i] >= mk.T) continue;
      const long long off = at(b, mk.T, key_r[i], mk.KV, kvh, D) + half * kN + col;
      if constexpr (kDk) store_row<C::kOut>(dk + off, acc, i, mk.scale);
      else store_row<C::kOut>(dv + off, acc, i, 1.f);
    }
  };
  if (warp >= 4) consume(std::true_type{});
  else consume(std::false_type{});
}

// dQ of kQTiles * P positions (kTile rows a resident tile) of one kv head's
// G heads: a block per (row tile, kv head, b), walking the key tiles its
// rows may see.  kQTiles = kWG: warpgroup w owns tile w; with two column
// halves (D = 256) both own the one tile and warpgroup w makes its dQ's
// columns [128 w, 128 w + 128).
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, Masks mk, int P) {
  using C = Cfg<D>;
  constexpr int kNS = C::kStages, kRB = C::kRowBytes, kT = C::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                              // [kQTiles] resident
  const uint32_t sdO = sQ + C::kQTiles * C::kTileBytes;
  const uint32_t sK = sdO + C::kQTiles * C::kTileBytes;  // [kNS] ring
  const uint32_t sV = sK + kNS * C::kTileBytes;
  const uint32_t bars = base + static_cast<uint32_t>(C::kDqTiles);
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kNS + s); };

  const int G = mk.G, S = mk.S, rows = G * P;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tile = gridDim.x - 1 - blockIdx.x;   // the longest causal rows first
  const int pos0 = tile * C::kQTiles * P;
  const int pos_end = min(S, pos0 + C::kQTiles * P);
  const int t_lo = mk.window > 0 ? max(0, pos0 + mk.qo - mk.window + 1) : 0;
  const int t_hi = mk.causal ? min(mk.T, pos_end + mk.qo) : mk.T;
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + kT - 1) / kT : 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kNS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::kWG * 4) {
    // ---- producer: Q and dO once, then K and V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (warp == C::kWG * 4 && lane == 0) {
      mbar_expect_tx(q_full, 2 * C::kQTiles * C::kNChunk * rows * kRB);
      for (int w = 0; w < C::kQTiles; ++w)
        for (int c = 0; c < C::kNChunk; ++c) {
          const uint32_t off = w * C::kTileBytes + c * kT * kRB;
          tma_load_4d(sQ + off, &qmap, q_full, c * C::kChunk, kvh * G, pos0 + w * P, b);
          tma_load_4d(sdO + off, &domap, q_full, c * C::kChunk, kvh * G, pos0 + w * P, b);
        }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kNS;
        const uint32_t ph = (n / kNS) & 1;
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), 2 * C::kTileBytes);
        for (int c = 0; c < C::kNChunk; ++c) {
          const uint32_t off = s * C::kTileBytes + c * kT * kRB;
          tma_load_4d(sK + off, &kmap, full(s), c * C::kChunk, kvh, t_lo + n * kT, b);
          tma_load_4d(sV + off, &vmap, full(s), c * C::kChunk, kvh, t_lo + n * kT, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes rows [0, rows) of Q and dO tile qt,
  // columns [half * kN, half * kN + kN) of their dQ
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  constexpr int kN = C::kN;
  const int wg = warp >> 2, w4 = warp & 3;
  const int qt = C::kHalves > 1 ? 0 : wg, half = C::kHalves > 1 ? wg : 0;
  const uint32_t sQw = sQ + qt * C::kTileBytes, sdOw = sdO + qt * C::kTileBytes;
  const int wpos0 = pos0 + qt * P;
  const int wpos_hi = min(S, wpos0 + P) - 1;        // < wpos0: no valid row
  const int col = (lane & 3) * 2;
  const float scale_log2 = mk.scale * kLog2e;
  int r_i[2], pos_r[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r_i[i] = w4 * 16 + (lane >> 2) + 8 * i;
    pos_r[i] = wpos0 + r_i[i] / G;
    const bool ok = r_i[i] < rows && pos_r[i] < S;
    const long long row =
        (static_cast<long long>(b) * mk.H + kvh * G + r_i[i] % G) * S + pos_r[i];
    lse2[i] = ok ? lse[row] * kLog2e : CUDART_INF_F;
    dlt[i] = ok ? delta[row] : 0.f;
  }

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kNS;
    const uint32_t ph = (n / kNS) & 1;
    const int t0 = t_lo + n * kT;
    mbar_wait(full(s), ph);
    const int m0 = wpos0 + mk.qo, m_hi = wpos_hi + mk.qo;   // mask positions
    const bool any = wpos_hi >= wpos0 && (!mk.causal || t0 <= m_hi) &&
                     (mk.window <= 0 || t0 + kT - 1 > m0 - mk.window);
    if (any) {
      const uint32_t sKs = sK + s * C::kTileBytes, sVs = sV + s * C::kTileBytes;
      float sc[kT / 2], dp[kT / 2];
      // S = Q K^T, dP = dO V^T: both operands K-major
      wgmma_fence();
      issue_s<D, kT, kRB>(sc, sQw, sKs);
      issue_s<D, kT, kRB>(dp, sdOw, sVs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kT / 2>(sc);
      fence_regs<kT / 2>(dp);
      const bool whole = t0 + kT <= mk.T && (!mk.causal || t0 + kT - 1 <= m0) &&
                         (mk.window <= 0 || t0 > m_hi - mk.window);
#define GRAD_TILE(cap, masked) \
  grad_tile_rows<kT, cap, masked>(sc, dp, lse2, dlt, pos_r, t0, col, mk, scale_log2)
      if (mk.softcap > 0.f) {
        if (whole) GRAD_TILE(true, false);
        else GRAD_TILE(true, true);
      } else {
        if (whole) GRAD_TILE(false, false);
        else GRAD_TILE(false, true);
      }
#undef GRAD_TILE
      uint32_t d_hi[kT / 16][4], d_lo[kT / 16][4];
      split_p<kT>(dp, d_hi, d_lo);
      // dQ += dS K: the half's columns of K read MN-major from the ring tile
      fence_regs<kN / 2>(acc);
      wgmma_fence();
      issue_split<kT, kN, kRB>(acc, d_hi, d_lo, sKs + half * C::kHalfOffset);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kN / 2>(acc);
      fence_u32<kT / 16>(d_hi);
      fence_u32<kT / 16>(d_lo);
    }
    mbar_arrive(empty(s));
  }

  // dq (B, S, H, D) contiguous, times the scale
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r_i[i] >= rows || pos_r[i] >= S) continue;
    store_row<C::kOut>(dq + at(b, S, pos_r[i], mk.H, kvh * G + r_i[i] % G, D) + half * kN + col,
                       acc, i, mk.scale);
  }
}

// The bf16 route's launch shape as bwd_launch_plan gives it.
struct Plan {
  int warpgroups, threads, stages, tile, chunk, swizzle_bytes, box_heads, box_pos, n_blocks;
};

template <int D>
int launch(bool dkdv, const Args& a, const Plan& p) {
  using C = Cfg<D>;
  const Masks& mk = a.mk;
  // the plan must be the one this instance was compiled for, its row box
  // one kv head's G heads over at most kTile rows, and its blocks must
  // reach T (dK/dV, kHalves blocks a key tile) or S (dQ)
  const long long reach = dkdv ? static_cast<long long>(p.n_blocks / C::kHalves) * C::kTile
                               : static_cast<long long>(p.n_blocks) * C::kQTiles * p.box_pos;
  if (p.warpgroups != C::kWG || p.threads != C::kThreads || p.stages != C::kStages ||
      p.tile != C::kTile || p.chunk != C::kChunk || p.swizzle_bytes != C::kRowBytes ||
      p.box_heads != mk.G || p.box_pos < 1 || p.box_pos * mk.G > C::kTile ||
      (dkdv && p.n_blocks % C::kHalves) || reach < (dkdv ? mk.T : mk.S))
    return static_cast<int>(cudaErrorInvalidValue);
  // q, dout (B, S, H, D) and k, v (B, T, KV, D) contiguous
  const long long qh = D, qs = static_cast<long long>(mk.H) * D, qb = qs * mk.S;
  const long long kh = D, ks = static_cast<long long>(mk.KV) * D, kb = ks * mk.T;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!make_map(&qmap, a.q, D, mk.H, mk.S, a.B, qh, qs, qb, p.chunk, mk.G, p.box_pos,
                p.swizzle_bytes) ||
      !make_map(&domap, a.dout, D, mk.H, mk.S, a.B, qh, qs, qb, p.chunk, mk.G, p.box_pos,
                p.swizzle_bytes) ||
      !make_map(&kmap, a.k, D, mk.KV, mk.T, a.B, kh, ks, kb, p.chunk, 1, C::kTile,
                p.swizzle_bytes) ||
      !make_map(&vmap, a.v, D, mk.KV, mk.T, a.B, kh, ks, kb, p.chunk, 1, C::kTile,
                p.swizzle_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.n_blocks, mk.KV, a.B);
  cudaError_t err;
  if (dkdv) {
    err = cudaFuncSetAttribute(dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::kDkdvSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_tc_kernel<D><<<grid, p.threads, C::kDkdvSmem, a.stream>>>(
        qmap, kmap, vmap, domap, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
        static_cast<__nv_bfloat16*>(a.dv), mk, p.box_pos);
  } else {
    err = cudaFuncSetAttribute(dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::kDqSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_tc_kernel<D><<<grid, p.threads, C::kDqSmem, a.stream>>>(
        qmap, kmap, vmap, domap, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), mk,
        p.box_pos);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_width(bool dkdv, int D, const Args& a, const Plan& p) {
  switch (D) {
    case 16: return launch<16>(dkdv, a, p);
    case 32: return launch<32>(dkdv, a, p);
    case 64: return launch<64>(dkdv, a, p);
    case 96: return launch<96>(dkdv, a, p);
    case 112: return launch<112>(dkdv, a, p);
    case 128: return launch<128>(dkdv, a, p);
    case 256: return launch<256>(dkdv, a, p);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// f32 on the CUDA cores; D = 256 takes tiles of 32 on the own axis (shared
// memory and registers).
template <int D>
int launch_width(bool dkdv, const Args& a) {
  constexpr int A = D == 256 ? 32 : 64;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  if (dkdv) {
    constexpr size_t bytes = dkdv_smem<D, A>();
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<D, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((a.mk.T + A - 1) / A, a.mk.KV, a.B);
    dkdv_kernel<D, A><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.mk);
  } else {
    constexpr size_t bytes = dq_smem<D, A>();
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<D, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((a.mk.S * a.mk.G + A - 1) / A, a.mk.KV, a.B);
    dq_kernel<D, A><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.mk);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(bool dkdv, int D, const Args& a) {
  switch (D) {
    case 16: return launch_width<16>(dkdv, a);
    case 32: return launch_width<32>(dkdv, a);
    case 64: return launch_width<64>(dkdv, a);
    case 96: return launch_width<96>(dkdv, a);
    case 112: return launch_width<112>(dkdv, a);
    case 128: return launch_width<128>(dkdv, a);
    case 256: return launch_width<256>(dkdv, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// route: 1 -> the tensor cores (bf16; the plan as bwd_launch_plan gives
// it), 0 -> the CUDA cores (f32; the plan is not used).
int launch(bool dkdv, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv, int B, int S,
           int T_len, int H, int KV, int D, int causal, int window, int q_offset, float softcap,
           float scale, int is_bf16, int route, const tc::Plan& plan, void* stream) {
  if (B == 0 || S == 0 || T_len == 0) return 0;
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, dk, dv, B, Masks{S, T_len, H, KV, H / KV, causal, window, q_offset, softcap, scale},
               static_cast<cudaStream_t>(stream)};
  if (!is_bf16) return route ? static_cast<int>(cudaErrorInvalidValue) : launch_f32(dkdv, D, a);
  return route ? tc::launch_width(dkdv, D, a, plan) : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// delta (B, H, S) fp32 from out and dout ((B, S, H, D) contiguous,
// n_rows = B * S * H rows); f32 or bf16 (is_bf16).
extern "C" int flash_attention_bwd_delta_launch(const void* out, const void* dout, void* delta,
                                                int n_rows, int D, int S, int H, int is_bf16,
                                                void* stream) {
  if (n_rows == 0) return 0;
  const dim3 grid((n_rows + kThreads / 32 - 1) / (kThreads / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    delta_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
        static_cast<float*>(delta), n_rows, D, S, H);
  else
    delta_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(out),
                                                  static_cast<const float*>(dout),
                                                  static_cast<float*>(delta), n_rows, D, S, H);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv (B, T, KV, D) in the inputs' dtype.  q, dout (B, S, H, D) and k, v
// (B, T, KV, D) contiguous; lse, delta (B, H, S) fp32; window <= 0: none,
// softcap <= 0: none; q_offset: the absolute position of q's row 0.  route and the plan (warpgroups ... n_blocks, see
// tc::Plan; the TMA boxes are (chunk, box_heads, box_pos) for q and dout,
// (chunk, 1, tile) for k and v) as bwd_launch_plan gives them.
extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int S, int T_len, int H, int KV, int D,
    int causal, int window, int q_offset, float softcap, float scale, int is_bf16, int route, int warpgroups,
    int threads, int stages, int tile, int chunk, int swizzle_bytes, int box_heads, int box_pos,
    int n_blocks, void* stream) {
  const tc::Plan plan{warpgroups, threads,   stages,  tile,    chunk,
                      swizzle_bytes, box_heads, box_pos, n_blocks};
  return launch(true, q, k, v, dout, lse, delta, nullptr, dk, dv, B, S, T_len, H, KV, D, causal,
                window, q_offset, softcap, scale, is_bf16, route, plan, stream);
}

// dq (B, S, H, D) in the inputs' dtype; arguments as above.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int S, int T_len, int H, int KV, int D, int causal,
    int window, int q_offset, float softcap, float scale, int is_bf16, int route, int warpgroups, int threads,
    int stages, int tile, int chunk, int swizzle_bytes, int box_heads, int box_pos, int n_blocks,
    void* stream) {
  const tc::Plan plan{warpgroups, threads,   stages,  tile,    chunk,
                      swizzle_bytes, box_heads, box_pos, n_blocks};
  return launch(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, T_len, H, KV, D,
                causal, window, q_offset, softcap, scale, is_bf16, route, plan, stream);
}
