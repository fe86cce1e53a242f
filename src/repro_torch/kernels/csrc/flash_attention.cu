// GQA prefill attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): q (B, S, H, D) against k, v (B, T, KV, D),
// f32 or bf16, out (B, S, H, D) in q's dtype.  Causal mask, sliding window,
// logit softcap c*tanh(s/c), scale; masked logits are -1e30 and contribute 0,
// the running max starts at -1e30 and the denominator is clamped at 1e-30, so
// a row with every logit masked gives 0 (as the TPU kernel does).
//
// What bounds it: at qwen3-1.7b's prefill (B=4, S=2048, H=16, KV=8, D=128,
// causal) the work is 4*B*H*D*S(S+1)/2 = 69 GFLOP over 50 MB of q/k/v/out,
// so the bound is the tensor cores' bf16 rate (0.07 ms at 989 TFLOP/s).
// This first version computes in fp32 on the CUDA cores, as the TPU kernel
// does (inputs converted to fp32 before both products), so it runs far from
// that bound; wgmma and a TMA pipeline are the later step.
//
// Design:
//   * One block per (b, kv head, tile of 64 rows), where a row is one
//     (position, group head) pair of the G = H / KV query heads sharing the
//     kv head: every K/V tile staged in shared memory serves all G heads (the
//     TPU grid re-read it for each group).  The TPU kernel carried m, l and
//     acc across a sequential grid axis; here a loop inside the block walks
//     the key tiles and keeps m, l and acc in registers.
//   * q, k, v are read in place through their (b, s, h) strides, 16 bytes
//     at a time: the last axis must be contiguous and every row 16-byte
//     aligned (the wrapper checks).  No transposed copies.
//   * Key tiles wholly outside the causal / window range of the block's rows
//     are not visited (they would add exactly 0); tiles that are partly
//     masked, and the ragged ends of S and T, are masked per element.
//   * Each thread owns 4 rows x 4 keys of the 64 x 64 score tile and
//     4 rows x D/16 columns of the output; row max and sum are reduced over
//     the 16 threads of a half-warp with shuffles.  K is staged transposed
//     with a padded stride and V reuses the same buffer after the scores are
//     taken, so two blocks fit on an SM at D = 128.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem_io.cuh"

namespace {

constexpr int kRows = 64;      // (position, group head) rows per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kKtStride = kKeys + 1;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  // Qs[kRows][D] + KVs[max(D * kKtStride, kKeys * D)] + Ps[kRows][kKeys]
  return sizeof(float) * (kRows * D + D * kKtStride + kRows * kKeys);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int S, int T_len, int H, int KV,
             long long qsb, long long qss, long long qsh,
             long long ksb, long long kst, long long ksh,
             long long vsb, long long vst, long long vsh,
             int causal, int window, float softcap, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kRows][D]
  float* KVs = Qs + kRows * D;         // K^T [D][kKtStride], then V [kKeys][D]
  float* Ps = KVs + D * kKtStride;     // [kRows][kKeys]

  const int G = H / KV;
  const int n_rows = S * G;
  const int r0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qb = q + b * qsb;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  constexpr int V = kVec<T>, DV = D / V;   // 16-byte pieces per row
  for (int i = tid; i < kRows * DV; i += kThreads) {
    const int rr = i / DV, d = (i - rr * DV) * V, r = r0 + rr;
    float x[V] = {};
    if (r < n_rows) {
      const int pos = r / G, g = r - pos * G;
      load16(qb + pos * qss + (kvh * G + g) * qsh + d, x);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) Qs[rr * D + d + j] = x[j];
  }

  // keys any row of this block may see
  const int pos_lo = r0 / G;
  const int pos_hi = (min(r0 + kRows, n_rows) - 1) / G;
  int t_lo = 0, t_hi = T_len;
  if (causal) t_hi = min(T_len, pos_hi + 1);
  if (window > 0) t_lo = max(0, pos_lo - window + 1);

  int my_pos[4];
  bool my_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    my_row[i] = r < n_rows;
    my_pos[i] = r / G;
  }

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = t_lo; t0 < t_hi; t0 += kKeys) {
    __syncthreads();  // previous tile's V and P are consumed
    for (int i = tid; i < kKeys * DV; i += kThreads) {
      const int c = i / DV, d = (i - c * DV) * V, t = t0 + c;
      float x[V] = {};
      if (t < T_len) load16(kb + t * kst + d, x);
#pragma unroll
      for (int j = 0; j < V; ++j) KVs[(d + j) * kKtStride + c] = x[j];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * D + d);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float bk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = KVs[(d + dd) * kKtStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = dd == 0 ? a[i].x : dd == 1 ? a[i].y : dd == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ai, bk[j], s[i][j]);
        }
      }
    }

    // mask, online softmax update
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        ok[j] = my_row[i] && t < T_len && (!causal || t <= my_pos[i]) &&
                (window <= 0 || t > my_pos[i] - window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok[j] ? x : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty * 4 + i) * kKeys + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < D / 16; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();  // scores taken: the K buffer can take V

    for (int i = tid; i < kKeys * DV; i += kThreads) {
      const int c = i / DV, d = (i - c * DV) * V, t = t0 + c;
      float x[V] = {};
      if (t < T_len) load16(vb + t * vst + d, x);
#pragma unroll
      for (int j = 0; j < V; ++j) KVs[c * D + d + j] = x[j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kKeys + c];
#pragma unroll
      for (int e = 0; e < D / 16; ++e) {
        const float vv = KVs[c * D + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(p[i], vv, acc[i][e]);
      }
    }
  }

  // out is (B, S, H, D) contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!my_row[i]) continue;
    const int r = r0 + ty * 4 + i, pos = r / G, g = r - pos * G;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + pos) * H + kvh * G + g) * D;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) store(orow + tx + 16 * e, acc[i][e] * inv);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
             int H, int KV, const long long* st, int causal, int window, float softcap,
             float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / KV;
  dim3 grid((S * G + kRows - 1) / kRows, KV, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_len, H, KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
             int H, int KV, int D, const long long* st, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, B, S, T_len, H, KV, st, causal, window, softcap, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, B, S, T_len, H, KV, st, causal, window, softcap, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, B, S, T_len, H, KV, st, causal, window, softcap, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, B, S, T_len, H, KV, st, causal, window, softcap, scale, stream);
    case 256: return launch_d<T, 256>(q, k, v, o, B, S, T_len, H, KV, st, causal, window, softcap, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap.  Strides in elements:
// q (b, s, h), k (b, t, kv), v (b, t, kv); out is (B, S, H, D) contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int T_len, int H, int KV, int D,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kst, long long ksh,
                                      long long vsb, long long vst, long long vsh,
                                      int causal, int window, float softcap, float scale,
                                      int is_bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_t<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, KV, D, st, causal,
                                           window, softcap, scale, s)
                 : launch_t<float>(q, k, v, o, B, S, T_len, H, KV, D, st, causal, window,
                                   softcap, scale, s);
}
