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
//   * Wide heads (D > 128, gemma's 256; split_plan's "combine" is
//     "last_block", pieces_per_lane 2) come with few (row, kv head) groups,
//     and a lane's serial work per slot grows with the heads of its block
//     (at D=256 a row takes all 32 lanes and five shuffles a dot).  There
//     decode_wide_kernel serves one head a block and a lane two 16-byte
//     pieces of a row (16 lanes a row at D=256 bf16: four shuffles a dot,
//     two rows a warp load; 8 heads a block and 32 lanes a row ran 3x
//     slower at gemma-2b's decode on the H100), a split is at least
//     min_chunk slots (its loads outweigh its merge and partial write), and
//     the combine is folded in: each block that wrote its partial takes a
//     ticket (an atomic on its (row, kv head, head)); the last of the row's
//     used splits merges them, each split's weight exp(m_s - M) computed
//     once into shared memory, in a fixed order, so the result does not
//     depend on which block came last (deterministic), and no second
//     launch runs.  kv_len = 0 is written by split 0.  Both kernels run one
//     body (decode_split); the narrow kernel takes none of the wide one's
//     arguments, so they cost its code nothing.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem_io.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnrollPieces = 4;  // 16-byte pieces of K (and of V) a lane loads at once
constexpr int kChunkAlign = 16;   // a row's chunk is a multiple of this many slots
constexpr int kMaxD = 256;           // 32 KB of shared memory at 8 heads
constexpr float kNegInf = -1e30f;

// Slots of one split for a row with `len` valid slots (the wrapper's
// row_chunk mirrors it): ceil(len / n_split) rounded up to kChunkAlign, at
// least min_chunk (a multiple of kChunkAlign).
__device__ __forceinline__ int row_chunk(int len, int n_split, int min_chunk) {
  const int c = (len + n_split - 1) / n_split;
  return max(min_chunk, (c + kChunkAlign - 1) / kChunkAlign * kChunkAlign);
}

// One split block.  GB: heads per block (a compile-time bound, ng <= GB
// used); PPL: 16-byte pieces of a row per lane, 1 on the narrow plan, 2 on
// the wide one, where the last block of a (row, kv head, head) merges its
// splits (out, lse) in place of the combine kernel.
template <typename TQ, typename TK, int GB, int PPL>
__device__ __forceinline__ void
decode_split(const TQ* __restrict__ q, const TK* __restrict__ k,
             const TK* __restrict__ v, const int* __restrict__ kv_len,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ acc_out, int* __restrict__ tickets,
             TQ* __restrict__ o, float* __restrict__ lse, int T_len, int H, int KV,
             int D, long long qsb, long long qsh, long long ksb, long long kst,
             long long ksh, long long vsb, long long vst, long long vsh, int n_split,
             int min_chunk, int n_hg, int lanes_log2, float softcap, float scale) {
  constexpr int V = kVec<TK>;                   // cache elements per 16-byte piece
  constexpr bool kLast = PPL == 2;              // the wide plan
  __shared__ float sm_m[kWarps][GB], sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][GB][kMaxD];

  const int split = blockIdx.x, kvh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int b = blockIdx.z;
  const int G = H / KV, g0 = hg * GB, ng = min(GB, G - g0);
  const int len = min(max(kv_len[b], 0), T_len);
  const int chunk = row_chunk(len, n_split, min_chunk);
  const int t_begin = split * chunk, t_end = min(t_begin + chunk, len);
  if (t_begin >= t_end) {                       // past this row's valid slots
    if (kLast && len == 0 && split == 0) {      // no valid slot: out 0, lse -inf
      const long long h0 = static_cast<long long>(b) * H + kvh * G + g0;
      for (int i = threadIdx.x; i < ng * D; i += kThreads) store(o + h0 * D + i, 0.f);
      if (lse != nullptr && threadIdx.x < ng) lse[h0 + threadIdx.x] = __int_as_float(0xff800000);
    }
    return;
  }

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

  // rows of K (and of V) a lane loads before using them: 4 pieces of 16
  // bytes each, so half the rows where a wide row takes two pieces a lane
  constexpr int kUnroll = kUnrollPieces / PPL;
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
  if constexpr (kLast) {
    // the partials are visible to the device before the ticket is taken
    __shared__ int last;
    __threadfence();
    __syncthreads();
    const int n_used = (len + chunk - 1) / chunk;
    if (threadIdx.x == 0)
      last = atomicAdd(tickets + (static_cast<long long>(b) * KV + kvh) * n_hg + hg, 1) ==
             n_used - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // merge the row's used splits: a warp a head
    // takes M and the weights w_s = exp(m_s - M) once (into sm_acc, free
    // now: n_used * GB <= kWarps * GB * kMaxD), L and lse (lanes over the
    // splits, reduced by shuffles: a fixed order); then out = sum_s acc_s w_s
    // / L, a thread holding kJ 4-column pieces and loading kU splits of them
    // at once, so that their L2 reads overlap
    const long long base = (static_cast<long long>(b) * KV + kvh) * n_split;
    float* w = &sm_acc[0][0][0];
    float* sm_inv = &sm_l[0][0];
    for (int g = warp; g < ng; g += kWarps) {
      const float* mg = m_out + base * G + g0 + g;
      float M = kNegInf;
      for (int s = lane; s < n_used; s += 32) M = fmaxf(M, __ldcg(mg + s * G));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
      float L = 0.f;
      for (int s = lane; s < n_used; s += 32) {
        const float ws = expf(__ldcg(mg + s * G) - M);
        w[s * GB + g] = ws;
        L += __ldcg(l_out + base * G + g0 + g + s * G) * ws;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
      if (lane == 0) {
        sm_inv[g] = 1.f / fmaxf(L, 1e-30f);
        if (lse != nullptr)   // -inf for a row with no valid slot
          lse[static_cast<long long>(b) * H + kvh * G + g0 + g] =
              L > 0.f ? M + logf(L) : __int_as_float(0xff800000);
      }
    }
    __syncthreads();
    constexpr int kJ = (GB * kMaxD / 4 + kThreads - 1) / kThreads;   // pieces a thread
    constexpr int kU = 16 / kJ;                                        // splits at once
    const int n4 = ng * D / 4;
    int off[kJ], gj[kJ];
    float4 a[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int i = threadIdx.x + j * kThreads;
      gj[j] = i < n4 ? 4 * i / D : -1;
      off[j] = i < n4 ? g0 * D + 4 * i : 0;
      a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float* part0 = acc_out + base * G * D;
    for (int s0 = 0; s0 < n_used; s0 += kU) {
      float4 x[kU][kJ];
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          x[u][j] = s0 + u < n_used && gj[j] >= 0
                        ? __ldcg(reinterpret_cast<const float4*>(
                              part0 + static_cast<long long>(s0 + u) * G * D + off[j]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          if (s0 + u < n_used && gj[j] >= 0) {
            const float ws = w[(s0 + u) * GB + gj[j]];
            a[j].x += x[u][j].x * ws;
            a[j].y += x[u][j].y * ws;
            a[j].z += x[u][j].z * ws;
            a[j].w += x[u][j].w * ws;
          }
    }
    TQ* ob = o + (static_cast<long long>(b) * H + kvh * G) * D;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      if (gj[j] >= 0) {
        const float inv = sm_inv[gj[j]];
        store(ob + off[j], a[j].x * inv);
        store(ob + off[j] + 1, a[j].y * inv);
        store(ob + off[j] + 2, a[j].z * inv);
        store(ob + off[j] + 3, a[j].w * inv);
      }
  }
}

// The narrow plan's split kernel: each block's partial (m, l, acc) for the
// combine kernel.
template <typename TQ, typename TK, int GB, int PPL>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int T_len, int H, int KV, int D,
                    long long qsb, long long qsh, long long ksb, long long kst, long long ksh,
                    long long vsb, long long vst, long long vsh, int n_split, int n_hg,
                    int lanes_log2, float softcap, float scale) {
  static_assert(PPL == 1, "the narrow plan reads one piece a lane");
  decode_split<TQ, TK, GB, PPL>(q, k, v, kv_len, m_out, l_out, acc_out, nullptr, nullptr,
                                nullptr, T_len, H, KV, D, qsb, qsh, ksb, kst, ksh, vsb, vst,
                                vsh, n_split, kChunkAlign, n_hg, lanes_log2, softcap, scale);
}

// The wide plan's: one head a block, two pieces a lane; the last block of a
// head's splits merges them into o (and lse).
template <typename TQ, typename TK>
__global__ void __launch_bounds__(kThreads)
decode_wide_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                   const TK* __restrict__ v, const int* __restrict__ kv_len,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ acc_out, int* __restrict__ tickets,
                   TQ* __restrict__ o, float* __restrict__ lse, int T_len, int H, int KV,
                   int D, long long qsb, long long qsh, long long ksb, long long kst,
                   long long ksh, long long vsb, long long vst, long long vsh, int n_split,
                   int min_chunk, int lanes_log2, float softcap, float scale) {
  decode_split<TQ, TK, 1, 2>(q, k, v, kv_len, m_out, l_out, acc_out, tickets, o, lse, T_len,
                             H, KV, D, qsb, qsh, ksb, kst, ksh, vsb, vst, vsh, n_split,
                             min_chunk, H / KV, lanes_log2, softcap, scale);
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
  const int chunk = row_chunk(len, n_split, kChunkAlign);
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

// The narrow plan (one piece a lane): the split kernel at GB heads a block,
// then the combine kernel.
template <typename TQ, typename TK, int GB>
int launch_g(const void* q, const void* k, const void* v, const int* kv_len, void* o,
             float* m_scr, float* l_scr, float* acc_scr, float* lse, int B, int T_len, int H,
             int KV, int D, const long long* st, int n_split, int lanes_log2, float softcap,
             float scale, cudaStream_t stream) {
  const int G = H / KV, n_hg = (G + GB - 1) / GB;
  dim3 grid(n_split, KV * n_hg, B);
  decode_split_kernel<TQ, TK, GB, 1><<<grid, kThreads, 0, stream>>>(
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

// The wide plan (two pieces a lane): one head a block, the last block of a
// head's splits merges them (the tickets start at 0; the weights of its
// splits fill sm_acc).
template <typename TQ, typename TK>
int launch_wide(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                float* m_scr, float* l_scr, float* acc_scr, int* tickets, float* lse, int B,
                int T_len, int H, int KV, int D, const long long* st, int n_split,
                int min_chunk, int lanes_log2, float softcap, float scale,
                cudaStream_t stream) {
  if (n_split > kWarps * kMaxD || tickets == nullptr ||
      reinterpret_cast<uintptr_t>(acc_scr) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(int) * B * KV * G, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_split, KV * G, B);
  decode_wide_kernel<TQ, TK><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v), kv_len,
      m_scr, l_scr, acc_scr, tickets, static_cast<TQ*>(o), lse, T_len, H, KV, D, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], n_split, min_chunk, lanes_log2, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TK>
int launch_t(int heads_per_block, int pieces_per_lane, const void* q, const void* k,
             const void* v, const int* kv_len, void* o, float* m_scr, float* l_scr,
             float* acc_scr, int* tickets, float* lse, int B, int T_len, int H, int KV, int D,
             const long long* st, int n_split, int min_chunk, int lanes_log2, float softcap,
             float scale, cudaStream_t stream) {
  if (D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (pieces_per_lane == 2) {
    if (heads_per_block != 1 || min_chunk < kChunkAlign || min_chunk % kChunkAlign)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wide<TQ, TK>(q, k, v, kv_len, o, m_scr, l_scr, acc_scr, tickets, lse, B,
                               T_len, H, KV, D, st, n_split, min_chunk, lanes_log2, softcap,
                               scale, stream);
  }
  if (pieces_per_lane != 1 || min_chunk != kChunkAlign)
    return static_cast<int>(cudaErrorInvalidValue);
#define ARGS q, k, v, kv_len, o, m_scr, l_scr, acc_scr, lse, B, T_len, H, KV, D, st, n_split, \
             lanes_log2, softcap, scale, stream
  switch (heads_per_block) {
    case 1: return launch_g<TQ, TK, 1>(ARGS);
    case 2: return launch_g<TQ, TK, 2>(ARGS);
    case 4: return launch_g<TQ, TK, 4>(ARGS);
    case 8: return launch_g<TQ, TK, 8>(ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
}

}  // namespace

// softcap <= 0: none.  Strides in elements: q (b, h); k, v (b, t, kv); out is
// (B, H, D) contiguous.  Scratch: m, l (B*KV*n_split*G), acc (... * D) fp32;
// tickets: (B*H) int32 on the wide plan (zeroed here), else unused.  lse:
// null, or (B, H) f32 contiguous for each row's log-sum-exp.  The plan
// (decode_attention.py::split_plan): n_split blocks per row and kv head,
// heads_per_block (1, 2, 4 or 8), L = 2**lanes_log2 lanes per cache row and
// pieces_per_lane 16-byte pieces of it per lane (L * pieces_per_lane * 16
// bytes >= a row), splits of at least min_chunk slots.  pieces_per_lane
// picks the route: 1, the narrow plan (min_chunk 16, a combine kernel
// merges the splits); 2, the wide plan (heads_per_block 1, at most 1024
// splits, the last block merges them; acc 16-byte aligned: that block reads
// it 16 bytes at a time).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* kv_len, void* o, float* m_scr,
                                       float* l_scr, float* acc_scr, void* tickets, float* lse,
                                       int B, int T_len, int H, int KV, int D, long long qsb,
                                       long long qsh, long long ksb, long long kst, long long ksh,
                                       long long vsb, long long vst, long long vsh,
                                       int n_split, int min_chunk, int heads_per_block,
                                       int lanes_log2, int pieces_per_lane, float softcap,
                                       float scale, int q_bf16, int kv_bf16, void* stream) {
  if (B == 0 || H == 0) return 0;
  const long long st[8] = {qsb, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tk = static_cast<int*>(tickets);
#define DECODE_ARGS heads_per_block, pieces_per_lane, q, k, v, kv_len, o, m_scr, l_scr, \
                    acc_scr, tk, lse, B, T_len, H, KV, D, st, n_split, min_chunk, lanes_log2, \
                    softcap, scale, s
  if (q_bf16)
    return kv_bf16 ? launch_t<__nv_bfloat16, __nv_bfloat16>(DECODE_ARGS)
                   : launch_t<__nv_bfloat16, float>(DECODE_ARGS);
  return kv_bf16 ? launch_t<float, __nv_bfloat16>(DECODE_ARGS)
                 : launch_t<float, float>(DECODE_ARGS);
#undef DECODE_ARGS
}
