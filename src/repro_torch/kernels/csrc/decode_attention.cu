// One-query GQA attention over a (ring) KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel): q (B, H, D) against a cache k, v
// (B, T, KV, D) with a per-row valid length kv_len (B,) int32, optional logit
// softcap, scale; out (B, H, D) in q's dtype.  q and the cache may differ in
// dtype (f32 or bf16 each); everything is computed in fp32.  Slots at or
// after kv_len are masked (-1e30, weight 0); the denominator is clamped at
// 1e-30, so kv_len = 0 gives 0.  On request the combine also writes each
// row's log-sum-exp over its valid slots, lse (B, H) f32 (-inf where kv_len
// = 0): what a caller needs to merge the outputs of several cache shards.
//
// What bounds it: the cache bytes, about 1 FLOP a byte.  At qwen3-1.7b's
// decode (B=4, KV=8, D=128, bf16, ~2k slots a row) one call reads up to
// 33.5 MB, 10 us at 3.35 TB/s.  Tensor cores do not matter; bytes in
// flight and busy threads do.
//
// Design:
//   * All G = H / KV query heads of one kv head share a block (up to 8 of
//     them; more heads take more blocks), so each cache byte is read once.
//     The slot axis of every row is cut into n_split chunks, one block each
//     (grid: n_split x KV*head groups x B); the chunk is planned on the card
//     from the row's valid slots, min(kv_len, T) (row_chunk), so a short row
//     spends next to nothing and no block reads past kv_len.  A block writes
//     its partial (m, l, acc); a second kernel merges a row's used splits.
//     The TPU kernel walked T sequentially with (m, l, acc) in scratch.
//   * Reads go straight from global memory into registers, 16 bytes a lane:
//     a cache row of D elements is spread over L lanes (L = 16 at D=128
//     bf16, two rows per warp load) and each lane loads U = 4 rows of K and
//     of V before it uses any, so 8 16-byte loads a lane are in flight.
//     Nothing is staged in shared memory.
//   * q for the block's heads lives in registers (fp32).  Each (head, slot)
//     dot is a per-lane partial reduced with shuffles over the row's L lanes.
//   * Each group of L lanes keeps its own online softmax (m, l per head, acc
//     for its D-slice) over the slots it reads, all heads together; the
//     groups of a warp merge by shuffles, the 4 warps once through shared
//     memory at the end.
//   * The cache is read in place through its (b, t, kv) strides: D must be a
//     multiple of 16 bytes and every cache row 16-byte aligned (the wrapper
//     checks).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem_io.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;        // rows of K (and of V) a lane loads before using them
constexpr int kChunkAlign = 16;   // a row's chunk is a multiple of this many slots
constexpr int kMaxD = 256;           // 32 KB of shared memory at 8 heads
constexpr float kNegInf = -1e30f;

// Slots of one split for a row with `len` valid slots (the wrapper's
// row_chunk mirrors it): ceil(len / n_split) rounded up to kChunkAlign.
__device__ __forceinline__ int row_chunk(int len, int n_split) {
  const int c = (len + n_split - 1) / n_split;
  return max(kChunkAlign, (c + kChunkAlign - 1) / kChunkAlign * kChunkAlign);
}

// GB: heads per block (a compile-time bound, ng <= GB used); PPL: 16-byte
// pieces of a row per lane.
template <typename TQ, typename TK, int GB, int PPL>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int T_len, int H, int KV, int D,
                    long long qsb, long long qsh, long long ksb, long long kst, long long ksh,
                    long long vsb, long long vst, long long vsh, int n_split, int n_hg,
                    int lanes_log2, float softcap, float scale) {
  constexpr int V = kVec<TK>;                   // cache elements per 16-byte piece
  __shared__ float sm_m[kWarps][GB], sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][GB][kMaxD];

  const int split = blockIdx.x, kvh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int b = blockIdx.z;
  const int G = H / KV, g0 = hg * GB, ng = min(GB, G - g0);
  const int len = min(max(kv_len[b], 0), T_len);
  const int chunk = row_chunk(len, n_split);
  const int t_begin = split * chunk, t_end = min(t_begin + chunk, len);
  if (t_begin >= t_end) return;                 // past this row's valid slots

  const int L = 1 << lanes_log2, RPW = 32 / L;  // lanes per row, rows per warp load
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> lanes_log2, li = lane & (L - 1);
  const int stream = warp * RPW + rg, n_streams = kWarps * RPW;
  const int NP = D / V;                         // pieces per row

  float qf[GB][PPL][V], acc[GB][PPL][V], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int p = 0; p < PPL; ++p)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int piece = li + L * p;
        acc[g][p][e] = 0.f;
        qf[g][p][e] = g < ng && piece < NP
                          ? to_f(q[b * qsb + (kvh * G + g0 + g) * qsh + piece * V + e])
                          : 0.f;
      }
  }
  const TK* kb = k + b * ksb + kvh * ksh;
  const TK* vb = v + b * vsb + kvh * vsh;

  for (int base = t_begin; base < t_end; base += kUnroll * n_streams) {
    uint4 kr[kUnroll][PPL], vr[kUnroll][PPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * n_streams + stream;
      ok[u] = t < t_end;
#pragma unroll
      for (int p = 0; p < PPL; ++p) {
        const int piece = li + L * p;
        const bool live = ok[u] && piece < NP;
        kr[u][p] = live ? __ldg(reinterpret_cast<const uint4*>(kb + t * kst + piece * V))
                        : make_uint4(0, 0, 0, 0);
        vr[u][p] = live ? __ldg(reinterpret_cast<const uint4*>(vb + t * vst + piece * V))
                        : make_uint4(0, 0, 0, 0);
      }
    }
    // scores: per-lane partial dots, reduced over the row's L lanes
    float s[kUnroll][GB];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[PPL][V];
#pragma unroll
      for (int p = 0; p < PPL; ++p) unpack16(kr[u][p], kb, kf[p]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
#pragma unroll
        for (int p = 0; p < PPL; ++p)
#pragma unroll
          for (int e = 0; e < V; ++e) d = fmaf(qf[g][p][e], kf[p][e], d);
        for (int off = L >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        float x = d * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u][g] = ok[u] ? x : kNegInf;
      }
    }
    // online softmax over the U slots, every head at once
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mt = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mt = fmaxf(mt, s[u][g]);
      const float m_new = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int p = 0; p < PPL; ++p)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][p][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float pu = ok[u] ? expf(s[u][g] - m_new) : 0.f;
        l[g] += pu;
        s[u][g] = pu;
      }
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[PPL][V];
#pragma unroll
      for (int p = 0; p < PPL; ++p) unpack16(vr[u][p], vb, vf[p]);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int p = 0; p < PPL; ++p)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[g][p][e] = fmaf(s[u][g], vf[p][e], acc[g][p][e]);
    }
  }

  // merge the row groups of the warp (lanes li of groups rg and rg ^ ...)
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], m2);
      const float a1 = expf(m[g] - mm), a2 = expf(m2 - mm);
      l[g] = l[g] * a1 + l2 * a2;
      m[g] = mm;
#pragma unroll
      for (int p = 0; p < PPL; ++p)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[g][p][e] = acc[g][p][e] * a1 +
                         __shfl_xor_sync(0xffffffffu, acc[g][p][e], off) * a2;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int p = 0; p < PPL; ++p) {
        const int piece = li + L * p;
        if (piece < NP)
#pragma unroll
          for (int e = 0; e < V; ++e) sm_acc[warp][g][piece * V + e] = acc[g][p][e];
      }
    }
  }
  __syncthreads();
  // merge the warps; partials: (B, KV, n_split, G) for m and l, (..., D) for acc
  const long long part = (static_cast<long long>(b) * KV + kvh) * n_split + split;
  for (int i = threadIdx.x; i < ng * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * a;
      aa += sm_acc[w][g][d] * a;
    }
    acc_out[(part * G + g0 + g) * D + d] = aa;
    if (d == 0) {
      m_out[part * G + g0 + g] = mm;
      l_out[part * G + g0 + g] = ll;
    }
  }
}

// One block per (b, h): merge the row's used splits; lse (when not null)
// takes the row's log-sum-exp, M + log L.
template <typename TQ>
__global__ void decode_combine_kernel(const float* __restrict__ m_in,
                                      const float* __restrict__ l_in,
                                      const float* __restrict__ acc_in,
                                      const int* __restrict__ kv_len, TQ* __restrict__ o,
                                      float* __restrict__ lse, int T_len, int H, int KV,
                                      int D, int n_split) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int G = H / KV, kvh = h / G, g = h - kvh * G;
  const int len = min(max(kv_len[b], 0), T_len);
  const int chunk = row_chunk(len, n_split);
  const int n_used = (len + chunk - 1) / chunk;
  const long long base = (static_cast<long long>(b) * KV + kvh) * n_split;
  float M = kNegInf;
  for (int s = 0; s < n_used; ++s) M = fmaxf(M, m_in[(base + s) * G + g]);
  float L = 0.f;
  for (int s = 0; s < n_used; ++s)
    L += l_in[(base + s) * G + g] * expf(m_in[(base + s) * G + g] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  if (lse != nullptr && threadIdx.x == 0)   // -inf for a row with no valid slot
    lse[bh] = L > 0.f ? M + logf(L) : __int_as_float(0xff800000);
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_used; ++s)
      a += acc_in[((base + s) * G + g) * D + e] * expf(m_in[(base + s) * G + g] - M);
    store(o + static_cast<long long>(bh) * D + e, a * inv);
  }
}

template <typename TQ, typename TK, int GB, int PPL>
int launch_g(const void* q, const void* k, const void* v, const int* kv_len, void* o,
             float* m_scr, float* l_scr, float* acc_scr, float* lse, int B, int T_len,
             int H, int KV, int D, const long long* st, int n_split, int lanes_log2,
             float softcap, float scale, cudaStream_t stream) {
  const int G = H / KV, n_hg = (G + GB - 1) / GB;
  dim3 grid(n_split, KV * n_hg, B);
  decode_split_kernel<TQ, TK, GB, PPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v), kv_len,
      m_scr, l_scr, acc_scr, T_len, H, KV, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], n_split, n_hg, lanes_log2, softcap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<TQ><<<B * H, 128, 0, stream>>>(m_scr, l_scr, acc_scr, kv_len,
                                                       static_cast<TQ*>(o), lse, T_len, H,
                                                       KV, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TK, int PPL>
int launch_p(int heads_per_block, const void* q, const void* k, const void* v,
             const int* kv_len, void* o, float* m_scr, float* l_scr, float* acc_scr,
             float* lse, int B, int T_len, int H, int KV, int D, const long long* st,
             int n_split, int lanes_log2, float softcap, float scale, cudaStream_t stream) {
#define ARGS q, k, v, kv_len, o, m_scr, l_scr, acc_scr, lse, B, T_len, H, KV, D, st, n_split, \
             lanes_log2, softcap, scale, stream
  switch (heads_per_block) {
    case 1: return launch_g<TQ, TK, 1, PPL>(ARGS);
    case 2: return launch_g<TQ, TK, 2, PPL>(ARGS);
    case 4: return launch_g<TQ, TK, 4, PPL>(ARGS);
    case 8: return launch_g<TQ, TK, 8, PPL>(ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
}

template <typename TQ, typename TK>
int launch_t(int heads_per_block, int pieces_per_lane, const void* q, const void* k,
             const void* v, const int* kv_len, void* o, float* m_scr, float* l_scr,
             float* acc_scr, float* lse, int B, int T_len, int H, int KV, int D,
             const long long* st, int n_split, int lanes_log2, float softcap, float scale,
             cudaStream_t stream) {
  if (D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
#define ARGS heads_per_block, q, k, v, kv_len, o, m_scr, l_scr, acc_scr, lse, B, T_len, H, KV, \
             D, st, n_split, lanes_log2, softcap, scale, stream
  switch (pieces_per_lane) {
    case 1: return launch_p<TQ, TK, 1>(ARGS);
    case 2:   // two pieces a lane only for an f32 cache row of more than 512 bytes
      if constexpr (sizeof(TK) == 4) return launch_p<TQ, TK, 2>(ARGS);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
}

}  // namespace

// softcap <= 0: none.  Strides in elements: q (b, h); k, v (b, t, kv); out is
// (B, H, D) contiguous.  Scratch: m, l (B*KV*n_split*G), acc (... * D) fp32.
// lse: null, or (B, H) f32 contiguous for each row's log-sum-exp.
// The plan (decode_attention.py::split_plan): n_split blocks per row and kv
// head, heads_per_block (1, 2, 4 or 8), L = 2**lanes_log2 lanes per cache row
// and pieces_per_lane 16-byte pieces of it per lane (L * pieces_per_lane *
// 16 bytes >= a row).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* kv_len, void* o, float* m_scr,
                                       float* l_scr, float* acc_scr, float* lse, int B,
                                       int T_len, int H, int KV, int D, long long qsb, long long qsh,
                                       long long ksb, long long kst, long long ksh,
                                       long long vsb, long long vst, long long vsh,
                                       int n_split, int heads_per_block, int lanes_log2,
                                       int pieces_per_lane, float softcap, float scale,
                                       int q_bf16, int kv_bf16, void* stream) {
  if (B == 0 || H == 0) return 0;
  const long long st[8] = {qsb, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_ARGS heads_per_block, pieces_per_lane, q, k, v, kv_len, o, m_scr, l_scr, \
                    acc_scr, lse, B, T_len, H, KV, D, st, n_split, lanes_log2, softcap, scale, s
  if (q_bf16)
    return kv_bf16 ? launch_t<__nv_bfloat16, __nv_bfloat16>(DECODE_ARGS)
                   : launch_t<__nv_bfloat16, float>(DECODE_ARGS);
  return kv_bf16 ? launch_t<float, __nv_bfloat16>(DECODE_ARGS)
                 : launch_t<float, float>(DECODE_ARGS);
#undef DECODE_ARGS
}
