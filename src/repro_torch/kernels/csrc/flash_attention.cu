// GQA prefill attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): q (B, S, H, D) against k, v (B, T, KV, D),
// f32 or bf16, out (B, S, H, D) in q's dtype.  Causal mask, sliding window,
// logit softcap c*tanh(s/c), scale, and q_offset, the absolute position of
// q's row 0 (a chunk of a longer prompt: row s is masked as position s +
// q_offset); masked logits are -1e30 and contribute 0,
// the running max starts at -1e30 and the denominator is clamped at 1e-30, so
// a row with every logit masked gives 0 (as the TPU kernel does).  Like the
// TPU kernel, both products take the inputs' values at fp32 precision and
// m, l and acc are fp32.  With a non-null lse pointer both routes also write
// each row's log-sum-exp m + log(l) of its scaled, capped logits, (B, H, S)
// fp32, +inf for a row that sees no key (what the backward,
// csrc/flash_attention_bwd.cu, recomputes the probabilities from); with
// null they write nothing else.
//
// What bounds it: at qwen3-1.7b's prefill (B=4, S=2048, H=16, KV=8, D=128,
// causal) the work is 4*B*H*D*S(S+1)/2 = 69 GFLOP over 100.7 MB of q, k, v
// and out (bf16), so the bound is the tensor cores' bf16 rate (0.07 ms at
// 989 TFLOP/s).
//
// Two routes, chosen by the wrapper from the dtype (kernels/flash_attention.py
// ::launch_plan) and dispatched explicitly here:
//
//   * bf16 -> flash_tc_kernel, on the tensor cores.  One block per (tile of
//     positions, kv head, b); each of its consumer warpgroups owns 64 rows,
//     a row being one (position, group head) pair of the G = H / KV query
//     heads sharing the kv head (row = position * G + head), so each K/V
//     tile serves all G heads.  One producer warp loads Q once and K and V
//     tiles through a two-stage ring with TMA (cp.async.bulk.tensor, 4-D
//     tensor maps over (D, heads, positions, batch) that read q, k, v in
//     place through their strides; out-of-range boxes read 0 and are masked),
//     signalled by mbarriers.  S = Q K^T is wgmma m64nNk16 (bf16 in, fp32
//     accumulate: a bf16 x bf16 product is exact in fp32, so this is the TPU
//     kernel's fp32 dot up to the order of the sum).  The online softmax runs
//     in fp32 registers, reduced over the 4 threads of an accumulator row.
//     acc += P V keeps p at fp32 precision: p is split into p_hi = bf16(p)
//     and p_lo = bf16(p - p_hi), two register-A wgmmas into one accumulator
//     with V read MN-major (transposed B) from the same smem tile, so p
//     keeps about 16 bits (a single bf16 P would round every weight to 8).
//     The TMA swizzle follows the row bytes of one box (32 B at D=16, 64 B
//     at D=32, 128 B from D=64; wider rows are loaded as 64-column chunks).
//     D=96 and 112 (zamba2's and phi-3-vision's heads) are not whole chunks:
//     their tiles are 128 columns wide, the last chunk's box runs past D and
//     TMA fills it with zeros, S takes only the D/16 real k16 steps, P V runs
//     at n128 (12.5-25 % of it on zero columns) and the store keeps D.
//     At D <= 128 the producer is a whole warpgroup that gives its
//     registers to the consumers (setmaxnreg 40 / 232).  D=256 (gemma's
//     heads) keeps two consumer warpgroups of 64 rows at full width and
//     64-key tiles, with no producer: a 64 x 256 fp32 accumulator alone is
//     128 registers a thread, and ptxas gives a block with a producer warp
//     or warpgroup beside two consumer warpgroups 168 (as if it were 384
//     threads, whatever setmaxnreg asks: 1.8 KB of spills), a block of 256
//     up to 255.  Thread 0 loads Q and the first ring stages; each later
//     K or V tile is loaded by the warpgroup that releases its stage last
//     (a count in shared memory: the first to release goes on, the second
//     issues the refill), so neither warpgroup waits for the other.  The
//     count is taken after the warpgroup's named barrier (all 128 threads
//     past wgmma_wait, so its reads of the stage are done) by an acq_rel
//     atomic, so those reads happen before the other warpgroup's refill,
//     as an mbarrier arrive / wait would order them.  S and
//     the softmax (softcap included) stay once a (row, key) pair and
//     nothing passes through shared memory but the TMA tiles: Q 2 x 32 KB
//     and a two-stage K / V ring of 4 x 32 KB, 193 KB.  Its grid is one
//     axis, longest causal range first over every (tile, kv head, batch)
//     (gemma-2b's MQA prefill: 192 blocks of unequal length on 132 SMs).
//     A consumer warpgroup runs S, the softmax (base 2, ex2.approx: 2 ulp)
//     and P V of one tile in turn; the two warpgroups of a block overlap
//     one's softmax with the other's products.  (Issuing S(n+1) beside
//     P(n) V(n) in one warpgroup needs more than the 168 registers a thread
//     the compiler allows here, spills, and was slower on the H100.)  What
//     holds it back (PERF.md): the fp32 softmax and the hi/lo split.  Its
//     PTX wrappers, S = Q K^T and the tensor maps are in hopper.cuh, shared
//     with the backward.
//   * f32 -> flash_kernel, the CUDA-core kernel below: a tensor-core product
//     would run in TF32 and break the 2e-5 limit fp32 is held to.  q, k, v
//     are staged in fp32 shared memory and every product is an fp32 FMA.
//
// Both routes skip key tiles wholly outside the causal / window range of a
// block's rows (they would add exactly 0) and mask per element only the
// tiles that are partly masked and the ragged ends of S and T.
//
// f32 route design: one block per (b, kv head, tile of 64 rows); each thread
// owns 4 rows x 4 keys of the 64 x 64 score tile and 4 rows x D/16 columns
// of the output; row max and sum are reduced over the 16 threads of a
// half-warp with shuffles.  K is staged transposed with a padded stride and
// V reuses the same buffer after the scores are taken, so two blocks fit on
// an SM at D = 128.  q, k, v are read in place, 16 bytes at a time (the
// wrapper checks the strides).
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "elem_io.cuh"
#include "hopper.cuh"

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
             T* __restrict__ o, float* __restrict__ lse, int S, int T_len, int H, int KV,
             long long qsb, long long qss, long long qsh,
             long long ksb, long long kst, long long ksh,
             long long vsb, long long vst, long long vsh,
             int causal, int window, int q_offset, float softcap, float scale) {
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

  // keys any row of this block may see (mask positions: row position + q_offset)
  const int pos_lo = r0 / G + q_offset;
  const int pos_hi = (min(r0 + kRows, n_rows) - 1) / G + q_offset;
  int t_lo = 0, t_hi = T_len;
  if (causal) t_hi = min(T_len, pos_hi + 1);
  if (window > 0) t_lo = max(0, pos_lo - window + 1);

  int my_pos[4];
  bool my_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    my_row[i] = r < n_rows;
    my_pos[i] = r / G + q_offset;
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
    if (lse != nullptr && tx == 0)   // m, l are the same in the half-warp
      lse[(static_cast<long long>(b) * H + kvh * G + g) * S + pos] =
          l[i] > 0.f ? m[i] + logf(l[i]) : CUDART_INF_F;
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
             int T_len, int H, int KV, const long long* st, int causal, int window, int q_offset,
             float softcap, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / KV;
  dim3 grid((S * G + kRows - 1) / kRows, KV, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, T_len, H, KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, window, q_offset, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
             int T_len, int H, int KV, int D, const long long* st, int causal, int window,
             int q_offset, float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, lse, B, S, T_len, H, KV, st, causal, window, q_offset, softcap, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, lse, B, S, T_len, H, KV, st, causal, window, q_offset, softcap, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, lse, B, S, T_len, H, KV, st, causal, window, q_offset, softcap, scale, stream);
    case 96: return launch_d<T, 96>(q, k, v, o, lse, B, S, T_len, H, KV, st, causal, window, q_offset, softcap, scale, stream);
    case 112: return launch_d<T, 112>(q, k, v, o, lse, B, S, T_len, H, KV, st, causal, window, q_offset, softcap, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, lse, B, S, T_len, H, KV, st, causal, window, q_offset, softcap, scale, stream);
    case 256: return launch_d<T, 256>(q, k, v, o, lse, B, S, T_len, H, KV, st, causal, window, q_offset, softcap, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ----------------------------------------------------------- bf16 route
namespace tc {

using namespace hopper;

// Shapes of the bf16 route for head width D and key tile BN.  The launch
// shape comes from kernels/flash_attention.py::launch_plan (the CPU tests
// check it there); `launch` refuses a plan that differs from these.  A D
// that is not whole chunks (96, 112) gets tiles kDp = 128 columns wide: the
// last chunk's TMA box runs past D and reads zeros there.
template <int D, int BN>
struct Cfg {
  static constexpr bool kWide = D == 256;             // full-width accumulators
  static constexpr int kWG = 2;                       // consumer warpgroups
  static constexpr int kBN = BN;                      // keys per tile
  static constexpr int kStages = 2;                   // K/V ring depth
  static constexpr int kRows = 64;                    // rows per warpgroup
  static constexpr int kChunk = D < 64 ? D : 64;      // columns per TMA box
  static constexpr int kNChunk = (D + kChunk - 1) / kChunk;
  static constexpr int kDp = kNChunk * kChunk;        // smem tile width
  static constexpr int kRowBytes = kChunk * 2;        // = the swizzle width
  static constexpr int kQBytes = kRows * kDp * 2;     // one warpgroup's Q
  static constexpr int kKVBytes = kBN * kDp * 2;      // one K or V tile
  // consumer warpgroups, then a producer warpgroup (one thread issues the
  // loads) whose registers setmaxnreg moves to the consumers; at D=256 no
  // producer: the consumers issue the loads and get up to 255 registers
  static constexpr int kThreads = kWG * 128 + (kWide ? 0 : 128);
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kWG) * kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

// Keys [t_lo, t_hi) that some position in [pos_lo, pos_end) may see.
__device__ __forceinline__ void key_range(int pos_lo, int pos_end, int T_len, int causal,
                                          int window, int& t_lo, int& t_hi) {
  t_lo = 0;
  t_hi = T_len;
  if (causal) t_hi = min(T_len, pos_end);
  if (window > 0) t_lo = max(0, pos_lo - window + 1);
}

// Which scores of a tile a warpgroup's rows may see, and how to scale them.
struct TileMask {
  int T_len, causal, window;     // positions below are mask positions (+ q_offset)
  float softcap, scale;
  float scale_log2;            // scale * log2(e): the softmax runs in base 2
  int wpos_lo, wpos_hi;        // the warpgroup's valid positions
  int pos[2];                  // this thread's two rows
  int col;                     // this thread's first column of each 8-column block
};

constexpr float kLog2e = 1.4426950408889634f;

// Online softmax of one tile, fp32, in base 2 (x * scale * log2 e, so
// exp2 of the difference is exp of the logits' difference).  sc[j*4 + i*2 + e]
// is (row i, key t0 + j*8 + col + e) and becomes p; m, l are updated and
// alpha is the factor acc must be scaled by.  Masked logits are -1e30 and
// weigh exactly 0; the row max and sum reduce over the 4 threads of a row.
// kCap: softcap; kMasked: the tile is partly masked or ragged (a tile every
// row sees whole skips the per-element test).  Max and sum run as four
// chains, so the row's kBN/4 values do not form one dependent chain.
template <int kBN, bool kCap, bool kMasked>
__device__ __forceinline__ void softmax_tile(float* sc, int t0, const TileMask& mk, float* m_r,
                                             float* l_r, float* alpha) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};   // 4 chains of max and sum
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& y = sc[j * 4 + i * 2 + e];
        if constexpr (kCap) y = mk.softcap * tanhf(y * mk.scale / mk.softcap) * kLog2e;
        else y *= mk.scale_log2;
        if constexpr (kMasked) {
          const int t = t0 + j * 8 + mk.col + e;
          const bool ok = t < mk.T_len && (!mk.causal || t <= mk.pos[i]) &&
                          (mk.window <= 0 || t > mk.pos[i] - mk.window);
          y = ok ? y : kNegInf;
        }
        mx[(j * 2 + e) & 3] = fmaxf(mx[(j * 2 + e) & 3], y);
      }
    float mt = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_r[i], mt);
    alpha[i] = exp2_approx(m_r[i] - m_new);
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& y = sc[j * 4 + i * 2 + e];
        float p = exp2_approx(y - m_new);
        if constexpr (kMasked) p = y == kNegInf ? 0.f : p;   // weight exactly 0
        y = p;
        sum[(j * 2 + e) & 3] += p;
      }
    float rs = (sum[0] + sum[1]) + (sum[2] + sum[3]);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_r[i] = l_r[i] * alpha[i] + rs;
    m_r[i] = m_new;
  }
}

template <int kBN>
__device__ __forceinline__ void softmax_any(float* sc, int t0, const TileMask& mk, float* m_r,
                                            float* l_r, float* alpha) {
  const bool whole = t0 + kBN <= mk.T_len && (!mk.causal || t0 + kBN - 1 <= mk.wpos_lo) &&
                     (mk.window <= 0 || t0 > mk.wpos_hi - mk.window);
  if (mk.softcap > 0.f) {
    if (whole) softmax_tile<kBN, true, false>(sc, t0, mk, m_r, l_r, alpha);
    else softmax_tile<kBN, true, true>(sc, t0, mk, m_r, l_r, alpha);
  } else {
    if (whole) softmax_tile<kBN, false, false>(sc, t0, mk, m_r, l_r, alpha);
    else softmax_tile<kBN, false, true>(sc, t0, mk, m_r, l_r, alpha);
  }
}

template <int D, int BN>
__global__ void __launch_bounds__(Cfg<D, BN>::kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int S, int T_len, int H, int KV, int P, int causal, int window,
                int q_offset, float softcap, float scale) {
  using C = Cfg<D, BN>;
  constexpr int kBN = C::kBN, kNS = C::kStages, kRB = C::kRowBytes, kDp = C::kDp;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::kWG * C::kQBytes;
  const uint32_t sV = sK + kNS * C::kKVBytes;
  const uint32_t bars = sV + kNS * C::kKVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kNS + s); };
  // at D=256 the two "empty" slots of a stage hold release counts, not mbarriers
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kNS + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kNS + s); };

  const int G = H / KV;
  int tile, kvh, b;   // the longest causal rows first
  if constexpr (C::kWide) {   // grid x: (tile, kv head, batch)
    const int n_pos_tiles = (S + C::kWG * P - 1) / (C::kWG * P);
    const int per_tile = gridDim.x / n_pos_tiles;   // KV * B blocks a tile
    const int r = blockIdx.x % per_tile;
    tile = n_pos_tiles - 1 - blockIdx.x / per_tile;
    kvh = r % KV;
    b = r / KV;
  } else {
    tile = gridDim.x - 1 - blockIdx.x;
    kvh = blockIdx.y;
    b = blockIdx.z;
  }
  const int pos0 = tile * C::kWG * P;
  const int pos_end = min(S, pos0 + C::kWG * P);
  int t_lo, t_hi;
  key_range(pos0 + q_offset, pos_end + q_offset, T_len, causal, window, t_lo, t_hi);
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + kBN - 1) / kBN : 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kNS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      if constexpr (C::kWide) {
        smem_store_u64(k_empty(s), 0);
        smem_store_u64(v_empty(s), 0);
      } else {
        mbar_init(k_empty(s), C::kWG * 128);
        mbar_init(v_empty(s), C::kWG * 128);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // D=256: K or V tile n into its ring stage, signalled on its full barrier
  auto load_kv = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, int n) {
    const int s = n % kNS;
    mbar_expect_tx(full, C::kKVBytes);
    for (int c = 0; c < C::kNChunk; ++c)
      tma_load_4d(ring + s * C::kKVBytes + c * kBN * kRB, map, full, c * C::kChunk, kvh,
                  t_lo + n * kBN, b);
  };
  if constexpr (C::kWide) {
    // no producer: thread 0 loads Q and the first stages of the ring
    if (tid == 0) {
      mbar_expect_tx(q_full, C::kWG * C::kNChunk * G * P * kRB);
      for (int w = 0; w < C::kWG; ++w)
        for (int c = 0; c < C::kNChunk; ++c)
          tma_load_4d(sQ + w * C::kQBytes + c * C::kRows * kRB, &qmap, q_full, c * C::kChunk,
                      kvh * G, pos0 + w * P, b);
      for (int n = 0; n < min(kNS, n_tiles); ++n) {
        load_kv(&kmap, sK, k_full(n), n);
        load_kv(&vmap, sV, v_full(n), n);
      }
    }
  } else if (warp >= C::kWG * 4) {
    // ---- producer: Q once, then K and V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (warp == C::kWG * 4 && lane == 0) {
      mbar_expect_tx(q_full, C::kWG * C::kNChunk * G * P * kRB);
      for (int w = 0; w < C::kWG; ++w)
        for (int c = 0; c < C::kNChunk; ++c)
          tma_load_4d(sQ + w * C::kQBytes + c * C::kRows * kRB, &qmap, q_full, c * C::kChunk,
                      kvh * G, pos0 + w * P, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kNS;
        const uint32_t ph = (n / kNS) & 1;
        const int t0 = t_lo + n * kBN;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), C::kKVBytes);
        for (int c = 0; c < C::kNChunk; ++c)
          tma_load_4d(sK + s * C::kKVBytes + c * kBN * kRB, &kmap, k_full(s), c * C::kChunk,
                      kvh, t0, b);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), C::kKVBytes);
        for (int c = 0; c < C::kNChunk; ++c)
          tma_load_4d(sV + s * C::kKVBytes + c * kBN * kRB, &vmap, v_full(s), c * C::kChunk,
                      kvh, t0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [0, G*P) of its Q tile
  if constexpr (!C::kWide)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int wg = warp >> 2, w4 = warp & 3;
  // release stage n % kNS of a ring: every thread of the warpgroup is past
  // its product; at D=256 the warpgroup counts itself once, and the second
  // of the two to do so loads tile n + kNS into the stage
  auto release = [&](uint32_t empty, const CUtensorMap* map, uint32_t ring, uint32_t full,
                     int n) {
    if constexpr (C::kWide) {
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (w4 == 0 && lane == 0 && (smem_atomic_add(empty, 1) & 1) && n + kNS < n_tiles)
        load_kv(map, ring, full, n + kNS);
    } else {
      mbar_arrive(empty);
    }
  };
  const uint32_t sQw = sQ + wg * C::kQBytes;
  const int wpos0 = pos0 + wg * P;
  const int wpos_hi = min(S, wpos0 + P) - 1;       // last valid position
  // this thread's two accumulator rows: w4*16 + lane/4 and that + 8
  int pos_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) pos_r[i] = wpos0 + (w4 * 16 + (lane >> 2) + 8 * i) / G;
  const int col = (lane & 3) * 2;                  // first of this thread's column pair

  float acc[kDp / 2];   // P V at the tile width: the columns past D stay 0
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  // Per key tile: S = Q K^T, the online softmax, acc = alpha * acc + P V;
  // each smem stage is released as soon as its product has landed.
  // the mask compares keys with positions + q_offset; pos_r stays the row's address
  const TileMask mask{T_len, causal, window, softcap, scale, scale * kLog2e, wpos0 + q_offset,
                      wpos_hi + q_offset, {pos_r[0] + q_offset, pos_r[1] + q_offset}, col};
  float alpha[2];
  mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kNS;
    const uint32_t ph = (n / kNS) & 1;
    float sc[kBN / 2];
    mbar_wait(k_full(s), ph);
    wgmma_fence();
    issue_s<D, kBN, kRB>(sc, sQw, sK + s * C::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kBN / 2>(sc);
    release(k_empty(s), &kmap, sK, k_full(s), n);
    softmax_any<kBN>(sc, t_lo + n * kBN, mask, m_r, l_r, alpha);
#pragma unroll
    for (int j = 0; j < kDp / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[j * 4 + i * 2] *= alpha[i];
        acc[j * 4 + i * 2 + 1] *= alpha[i];
      }
    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
    split_p<kBN>(sc, p_hi, p_lo);
    // acc += P V: V is MN-major (D contiguous); 64-column chunks LBO apart,
    // 8-key groups SBO apart, a k16 step is 16 key rows
    mbar_wait(v_full(s), ph);
    fence_regs<kDp / 2>(acc);
    wgmma_fence();
    const uint64_t vd = smem_desc(sV + s * C::kKVBytes, kBN * kRB, 8 * kRB, kRB);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_rs<kDp>(acc, p_hi[kk], vd + ((kk * 16 * kRB) >> 4));
      wgmma_rs<kDp>(acc, p_lo[kk], vd + ((kk * 16 * kRB) >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kDp / 2>(acc);
    release(v_empty(s), &vmap, sV, v_full(s), n);
  }

  // out (B, S, H, D) contiguous: acc[j*4 + i*2 + e] is (row i, column j*8 + col + e);
  // only the first D columns are stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w4 * 16 + (lane >> 2) + 8 * i;
    if (r >= G * P || pos_r[i] >= S) continue;
    const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
    if (lse != nullptr && (lane & 3) == 0)   // m, l are the same in the row's 4 threads
      lse[(static_cast<long long>(b) * H + kvh * G + r % G) * S + pos_r[i]] =
          l_r[i] > 0.f ? (m_r[i] + log2f(l_r[i])) * 0.6931471805599453f  // base 2 -> e
                       : CUDART_INF_F;
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * S + pos_r[i]) * H + kvh * G + r % G) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j * 4 + i * 2] * inv, acc[j * 4 + i * 2 + 1] * inv);
  }
}

// The bf16 route's launch shape as launch_plan gives it (n_pos_tiles: the
// grid's x, which on a flat grid (D=256) counts (tile, kv head, batch)).
struct Plan {
  int warpgroups, threads, stages, key_tile, chunk, swizzle_bytes, box_heads, box_pos,
      n_pos_tiles;
};

template <int D, int BN>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int T_len, int H, int KV, const long long* st, int causal, int window, int q_offset,
           float softcap, float scale, const Plan& p, cudaStream_t stream) {
  using C = Cfg<D, BN>;
  const int G = H / KV;
  // the plan must be the one this instance was compiled for, its q box one
  // kv head's G heads over at most 64 rows, and its blocks must reach S
  if (p.warpgroups != C::kWG || p.threads != C::kThreads || p.stages != C::kStages ||
      p.key_tile != C::kBN || p.chunk != C::kChunk || p.swizzle_bytes != C::kRowBytes ||
      p.box_heads != G || p.box_pos < 1 || p.box_pos * G > C::kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  // blocks along the grid's x: position tiles reaching S, or on a flat grid
  // exactly every (tile, kv head, batch)
  const long long n_tiles = (S + C::kWG * p.box_pos - 1) / (C::kWG * p.box_pos);
  if (C::kWide ? p.n_pos_tiles != n_tiles * KV * B
                   : static_cast<long long>(p.n_pos_tiles) * C::kWG * p.box_pos < S)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, D, H, S, B, st[2], st[1], st[0], p.chunk, p.box_heads, p.box_pos,
                p.swizzle_bytes) ||
      !make_map(&kmap, k, D, KV, T_len, B, st[5], st[4], st[3], p.chunk, 1, p.key_tile,
                p.swizzle_bytes) ||
      !make_map(&vmap, v, D, KV, T_len, B, st[8], st[7], st[6], p.chunk, 1, p.key_tile,
                p.swizzle_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<D, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = C::kWide ? dim3(p.n_pos_tiles, 1, 1) : dim3(p.n_pos_tiles, KV, B);
  flash_tc_kernel<D, BN><<<grid, p.threads, C::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, S, T_len, H, KV, p.box_pos, causal,
      window, q_offset, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap; q_offset: the absolute
// position of q's row 0 (the masks compare key t with position s + q_offset;
// out, lse and q are addressed by s).  Strides in elements:
// q (b, s, h), k (b, t, kv), v (b, t, kv); out is (B, S, H, D) contiguous;
// lse (B, H, S) fp32 or null (not written; with T_len = 0 the bf16 route
// writes no lse either).
// is_bf16 picks the route: bf16 -> tensor cores, launched as the plan from
// launch_plan says (warpgroups ... n_pos_tiles, see tc::Plan; the TMA boxes
// are (chunk, box_heads, box_pos) for q and (chunk, 1, key_tile) for k, v),
// f32 -> CUDA cores (the plan values are not used).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse_out, int B, int S, int T_len, int H, int KV, int D,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kst, long long ksh,
                                      long long vsb, long long vst, long long vsh,
                                      int causal, int window, int q_offset, float softcap,
                                      float scale, int is_bf16, int warpgroups, int threads, int stages,
                                      int key_tile, int chunk, int swizzle_bytes,
                                      int box_heads, int box_pos, int n_pos_tiles,
                                      void* stream) {
  if (B == 0 || S == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  float* lse = static_cast<float*>(lse_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_t<float>(q, k, v, o, lse, B, S, T_len, H, KV, D, st, causal, window, q_offset,
                           softcap, scale, s);
  if (T_len == 0)   // no key: every row is 0
    return static_cast<int>(cudaMemsetAsync(o, 0, sizeof(__nv_bfloat16) * B * S * H * D, s));
  const tc::Plan plan{warpgroups, threads,   stages,  key_tile,   chunk,
                      swizzle_bytes, box_heads, box_pos, n_pos_tiles};
#define TC_ARGS \
  q, k, v, o, lse, B, S, T_len, H, KV, st, causal, window, q_offset, softcap, scale, plan, s
  switch (D * 1000 + key_tile) {
    case 16064: return tc::launch<16, 64>(TC_ARGS);
    case 32064: return tc::launch<32, 64>(TC_ARGS);
    case 64064: return tc::launch<64, 64>(TC_ARGS);
    case 96064: return tc::launch<96, 64>(TC_ARGS);
    case 112064: return tc::launch<112, 64>(TC_ARGS);
    case 128064: return tc::launch<128, 64>(TC_ARGS);
    case 256064: return tc::launch<256, 64>(TC_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TC_ARGS
}
