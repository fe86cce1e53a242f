// One-query GQA attention over a (ring) KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel): q (B, H, D) against a cache k, v
// (B, T, KV, D) with a per-row valid length kv_len (B,) int32, optional logit
// softcap, scale; out (B, H, D) in q's dtype.  q and the cache may differ in
// dtype (f32 or bf16 each); everything is computed in fp32.  Slots at or
// after kv_len are masked (-1e30, weight 0); the denominator is clamped at
// 1e-30, so kv_len = 0 gives 0.
//
// What bounds it: the cache bytes.  At qwen3-1.7b's decode (B=4, KV=8,
// D=128, bf16, ~2k slots) one call reads 4*2048*8*128*2*2 = 33.5 MB for
// 4*H*D FLOP per slot, so it is bound by HBM (10 us at 3.35 TB/s).
//
// Design:
//   * All G = H / KV query heads of one kv head share a block, so each cache
//     byte is read once.  B * KV blocks alone would fill a quarter of the
//     132 SMs, so the T axis is split into chunks, one block each
//     (grid: splits x KV x B); a block writes its partial (m, l, acc) and a
//     second kernel merges the splits with the usual rescaling.  The TPU
//     kernel walked T sequentially with (m, l, acc) in scratch.
//   * A split only reads slots below kv_len: blocks wholly past it write an
//     empty partial without touching the cache.
//   * The cache is read in place through its (b, t, kv) strides, 16 bytes
//     at a time: D must be a multiple of 8 and every cache row 16-byte
//     aligned (the wrapper checks).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem_io.cuh"

namespace {

constexpr int kKeys = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// smem: Qs[G][D], Ks[kKeys][D+1] (V reuses it as [kKeys][D]), Ss[G][kKeys],
// As[G][D], m[G], l[G], alpha[G]
__host__ __device__ inline size_t smem_floats(int G, int D) {
  return static_cast<size_t>(G) * D + kKeys * (D + 1) + G * kKeys + G * D + 3 * G;
}

template <typename TQ, typename TK>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int T_len, int H, int KV, int D,
                    long long qsb, long long qsh, long long ksb, long long kst, long long ksh,
                    long long vsb, long long vst, long long vsh, int chunk, float softcap,
                    float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  float* Qs = smem;
  float* KVs = Qs + G * D;
  float* Ss = KVs + kKeys * (D + 1);
  float* As = Ss + G * kKeys;
  float* Ms = As + G * D;
  float* Ls = Ms + G;
  float* Al = Ls + G;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, tid = threadIdx.x;
  const int len = min(max(kv_len[b], 0), T_len);
  const int t_begin = split * chunk, t_end = min(t_begin + chunk, len);

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    Qs[i] = to_f(q[b * qsb + (kvh * G + g) * qsh + d]);
    As[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  constexpr int V = kVec<TK>;   // cache elements per 16-byte load
  const int DV = D / V;
  const TK* kb = k + b * ksb + kvh * ksh;
  const TK* vb = v + b * vsb + kvh * vsh;

  for (int t0 = t_begin; t0 < t_end; t0 += kKeys) {
    const int n = min(kKeys, t_end - t0);
    __syncthreads();
    for (int i = tid; i < n * DV; i += kThreads) {
      const int c = i / DV, d = (i - c * DV) * V;
      float x[V];
      load16(kb + (t0 + c) * kst + d, x);
#pragma unroll
      for (int j = 0; j < V; ++j) KVs[c * (D + 1) + d + j] = x[j];
    }
    __syncthreads();
    for (int i = tid; i < G * kKeys; i += kThreads) {
      const int g = i / kKeys, c = i - g * kKeys;
      float x = kNegInf;
      if (c < n) {
        const float* qr = Qs + g * D;
        const float* kr = KVs + c * (D + 1);
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        x = s * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      }
      Ss[i] = x;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {   // one thread per head row
      float mt = kNegInf;
      for (int c = 0; c < n; ++c) mt = fmaxf(mt, Ss[g * kKeys + c]);
      const float m_new = fmaxf(Ms[g], mt);
      float rs = 0.f;
      for (int c = 0; c < kKeys; ++c) {
        const float p = c < n ? expf(Ss[g * kKeys + c] - m_new) : 0.f;
        Ss[g * kKeys + c] = p;
        rs += p;
      }
      const float alpha = expf(Ms[g] - m_new);
      Al[g] = alpha;
      Ls[g] = Ls[g] * alpha + rs;
      Ms[g] = m_new;
    }
    __syncthreads();   // scores taken: the K buffer can take V
    for (int i = tid; i < n * DV; i += kThreads) {
      const int c = i / DV, d = (i - c * DV) * V;
      float x[V];
      load16(vb + (t0 + c) * vst + d, x);
#pragma unroll
      for (int j = 0; j < V; ++j) KVs[c * D + d + j] = x[j];
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, e = i - g * D;
      const float* p = Ss + g * kKeys;
      float a = As[i] * Al[g];
      for (int c = 0; c < n; ++c) a = fmaf(p[c], KVs[c * D + e], a);
      As[i] = a;
    }
  }
  __syncthreads();
  // partials: (B, KV, n_split, G) for m and l, (B, KV, n_split, G, D) for acc
  const long long part = (static_cast<long long>(b) * KV + kvh) * n_split + split;
  for (int i = tid; i < G * D; i += kThreads) acc_out[part * G * D + i] = As[i];
  for (int g = tid; g < G; g += kThreads) {
    m_out[part * G + g] = Ms[g];
    l_out[part * G + g] = Ls[g];
  }
}

// One block per (b, h): merge the splits' partials.
template <typename TQ>
__global__ void decode_combine_kernel(const float* __restrict__ m_in,
                                      const float* __restrict__ l_in,
                                      const float* __restrict__ acc_in, TQ* __restrict__ o,
                                      int H, int KV, int D, int n_split) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int G = H / KV, kvh = h / G, g = h - kvh * G;
  const long long base = (static_cast<long long>(b) * KV + kvh) * n_split;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, m_in[(base + s) * G + g]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s) L += l_in[(base + s) * G + g] * expf(m_in[(base + s) * G + g] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += acc_in[((base + s) * G + g) * D + e] * expf(m_in[(base + s) * G + g] - M);
    store(o + static_cast<long long>(bh) * D + e, a * inv);
  }
}

template <typename TQ, typename TK>
int launch_t(const void* q, const void* k, const void* v, const int* kv_len, void* o,
             float* m_scr, float* l_scr, float* acc_scr, int B, int T_len, int H, int KV,
             int D, const long long* st, int n_split, int chunk, float softcap, float scale,
             cudaStream_t stream) {
  const int G = H / KV;
  const size_t bytes = smem_floats(G, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<TQ, TK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_split, KV, B);
  decode_split_kernel<TQ, TK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v),
      kv_len, m_scr, l_scr, acc_scr, T_len, H, KV, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], chunk, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<TQ><<<B * H, 128, 0, stream>>>(m_scr, l_scr, acc_scr,
                                                       static_cast<TQ*>(o), H, KV, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// softcap <= 0: none.  Strides in elements: q (b, h); k, v (b, t, kv); out is
// (B, H, D) contiguous.  Scratch: m, l (B*KV*n_split*G), acc (... * D) fp32;
// split s covers slots [s*chunk, (s+1)*chunk).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* kv_len, void* o, float* m_scr,
                                       float* l_scr, float* acc_scr, int B, int T_len, int H,
                                       int KV, int D, long long qsb, long long qsh,
                                       long long ksb, long long kst, long long ksh,
                                       long long vsb, long long vst, long long vsh,
                                       int n_split, int chunk, float softcap, float scale,
                                       int q_bf16, int kv_bf16, void* stream) {
  if (B == 0 || H == 0) return 0;
  const long long st[8] = {qsb, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_ARGS q, k, v, kv_len, o, m_scr, l_scr, acc_scr, B, T_len, H, KV, D, st, \
                    n_split, chunk, softcap, scale, s
  if (q_bf16)
    return kv_bf16 ? launch_t<__nv_bfloat16, __nv_bfloat16>(DECODE_ARGS)
                   : launch_t<__nv_bfloat16, float>(DECODE_ARGS);
  return kv_bf16 ? launch_t<float, __nv_bfloat16>(DECODE_ARGS)
                 : launch_t<float, float>(DECODE_ARGS);
#undef DECODE_ARGS
}
