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
//   dV    = P^T dO,   dK = scale dS^T Q               dkdv_kernel
//   dS    = P * (dO V^T - delta) * (1 - tanh^2(scale q.k / softcap))
//   dQ    = scale dS K                                dq_kernel
//
// The masks are the forward's: causal t <= s, window t > s - window, t < T.
//
// What bounds it: at qwen3-1.7b's training shape (B=4, S=2048, H=16, KV=8,
// D=128, causal) the five products over the causal half are 2.5x the
// forward's operations, 172 GFLOP: on an H100 SXM (700 W) 0.17 ms at the
// tensor cores' bf16 peak, 2.6 ms at the CUDA cores' fp32 peak, which is the
// rate this kernel runs at.
// This first version is simple and exact: every product is an fp32 FMA on
// the CUDA cores over fp32 tiles in shared memory (bf16 inputs are widened
// as they are loaded, so both dtypes share one code path), and S and dP are
// computed in both the dK/dV and the dQ kernel (7 products where 5 are
// needed).  wgmma and TMA are later work.
//
// Deterministic, without atomics: a dK/dV block owns one (key tile, kv head,
// batch) and loops over every query row that may see its keys, for all G
// query heads of the kv head (row = position * G + head, the forward's
// rows), so the GQA sum is made inside the block; a dQ block owns one (tile
// of rows, kv head, batch) and loops over the key tiles its rows may see.
// Every output element is summed by one thread in a fixed order.
//
// Layout: thread (ty, tx) of 16 x 16 owns A/16 entries of the tile's own
// axis (keys in dK/dV, query rows in dQ) and 4 of the 64 entries of the
// other axis (tx + 16 j).  Own-axis operands sit row-major in shared memory
// (float4 reads that a half-warp shares); other-axis operands are stored
// transposed with a stride of 65 words, so consecutive threads read
// consecutive words, and a read down a column (fixed other index, d = tx +
// 16 e) also falls on distinct banks.  q, k, v, out and dO are contiguous
// (the wrapper passes contiguous copies).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "elem_io.cuh"

namespace {

constexpr int kThreads = 256;     // 16 x 16
constexpr int kOther = 64;        // the other axis of a score tile: 4 a thread
constexpr int kTs = kOther + 1;   // row stride of a transposed tile [D][kTs]
constexpr int kPs = kOther + 4;   // row stride of a score tile [own][kPs]

struct Masks {
  int S, T, H, KV, G, causal, window;
  float softcap, scale;
  __device__ __forceinline__ bool visible(int pos, int t) const {
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

// One D-wide row at src (16-byte aligned; nullptr: zeros) into dst[d * step].
template <typename T, int D>
__device__ __forceinline__ void load_piece(const T* src, int piece, float* dst, int step) {
  constexpr int V = kVec<T>;
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

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Masks mk) {
  constexpr int KPT = BK / 16, E = D / 16, kKs = D + 4, DV = D / kVec<T>;
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
    load_piece<T, D>(t < mk.T ? k + off : nullptr, i - c * DV, Ks + c * kKs, 1);
    load_piece<T, D>(t < mk.T ? v + off : nullptr, i - c * DV, Vs + c * kKs, 1);
  }

  // the rows that may see a key of this tile
  const int t_last = min(t0 + BK, mk.T) - 1;
  const int pos_lo = mk.causal ? t0 : 0;
  const int pos_hi = mk.window > 0 ? min(S - 1, t_last + mk.window - 1) : S - 1;
  const int r_begin = pos_lo * G, r_end = (pos_hi + 1) * G;

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
      load_piece<T, D>(r < r_end ? q + off : nullptr, i - rr * DV, Qt + rr, kTs);
      load_piece<T, D>(r < r_end ? dout + off : nullptr, i - rr * DV, dOt + rr, kTs);
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

template <typename T, int D, int BR>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Masks mk) {
  constexpr int RPT = BR / 16, E = D / 16, kQs = D + 4, DV = D / kVec<T>;
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
    load_piece<T, D>(r < n_rows ? q + off : nullptr, i - rr * DV, Qs + rr * kQs, 1);
    load_piece<T, D>(r < n_rows ? dout + off : nullptr, i - rr * DV, dOs + rr * kQs, 1);
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

  // the keys this block's rows may see
  const int pos_lo = r0 / G, pos_hi = (min(r0 + BR, n_rows) - 1) / G;
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
      load_piece<T, D>(t < mk.T ? k + off : nullptr, i - c * DV, Kt + c, kTs);
      load_piece<T, D>(t < mk.T ? v + off : nullptr, i - c * DV, Vt + c, kTs);
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
    T* row = dq + at(b, S, pos_r[i], mk.H, kvh * G + r - pos_r[i] * G, D);
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

// D = 256 takes tiles of 32 on the own axis (shared memory and registers).
template <typename T, int D>
int launch_width(bool dkdv, const Args& a) {
  constexpr int A = D == 256 ? 32 : 64;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (dkdv) {
    constexpr size_t bytes = dkdv_smem<D, A>();
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<T, D, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((a.mk.T + A - 1) / A, a.mk.KV, a.B);
    dkdv_kernel<T, D, A><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.mk);
  } else {
    constexpr size_t bytes = dq_smem<D, A>();
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<T, D, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((a.mk.S * a.mk.G + A - 1) / A, a.mk.KV, a.B);
    dq_kernel<T, D, A><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.mk);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(bool dkdv, int D, const Args& a) {
  switch (D) {
    case 16: return launch_width<T, 16>(dkdv, a);
    case 32: return launch_width<T, 32>(dkdv, a);
    case 64: return launch_width<T, 64>(dkdv, a);
    case 96: return launch_width<T, 96>(dkdv, a);
    case 112: return launch_width<T, 112>(dkdv, a);
    case 128: return launch_width<T, 128>(dkdv, a);
    case 256: return launch_width<T, 256>(dkdv, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(bool dkdv, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv, int B, int S,
           int T_len, int H, int KV, int D, int causal, int window, float softcap, float scale,
           int is_bf16, void* stream) {
  if (B == 0 || S == 0 || T_len == 0) return 0;
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, dk, dv, B, Masks{S, T_len, H, KV, H / KV, causal, window, softcap, scale},
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch_type<__nv_bfloat16>(dkdv, D, a) : launch_type<float>(dkdv, D, a);
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
// softcap <= 0: none.
extern "C" int flash_attention_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv, int B,
                                               int S, int T_len, int H, int KV, int D,
                                               int causal, int window, float softcap,
                                               float scale, int is_bf16, void* stream) {
  return launch(true, q, k, v, dout, lse, delta, nullptr, dk, dv, B, S, T_len, H, KV, D, causal,
                window, softcap, scale, is_bf16, stream);
}

// dq (B, S, H, D) in the inputs' dtype; arguments as above.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, int B, int S,
                                             int T_len, int H, int KV, int D, int causal,
                                             int window, float softcap, float scale,
                                             int is_bf16, void* stream) {
  return launch(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, T_len, H, KV, D,
                causal, window, softcap, scale, is_bf16, stream);
}
