// RMSNorm, and the attention's q/k bias, qk-norm and rotary embedding, each
// as one pass over bf16 rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these sites to XLA, which
// fuses each into the neighbouring work on the TPU.  On the card the port ran
// them as PyTorch's eager chains of float32 elementwise passes (an upcast, a
// square, a mean, two products, a cast back: about 40 bytes moved for every
// element of an RMSNorm; the rotation's halves, products, sums, `cat` and
// cast: about 48), the largest device cost of a qwen3-1.7b prefill.
//
//   rms_norm_kernel <- models/layers.py::rms_norm (kernels/ref.py::rms_norm_ref):
//       y = bf16(x * rsqrt(mean(x^2) + eps) * (1 + scale)) over rows of d;
//       with a residual, x is first bf16(residual + x), written out too.
//   qk_rope_kernel  <- models/attention.py's bias add, rms_norm of q and k per
//       head, and the split-halves rotation (kernels/ref.py::qk_rope_ref,
//       ::apply_rope).
//
// What bounds them: bytes.  Each reads its bf16 rows once and writes them
// once (the norm 4 bytes an element, 8 with the residual and the sum) at a
// few FLOP an element; the scales, biases and angles are a few KB that stay
// in L1 and L2.  So the design keeps every value of a row in registers
// between the read and the write, and moves rows as 16-byte vectors.
//
// Numbers: every value is computed in float32 and rounded to bf16 at the
// same points as the plain PyTorch chain (the residual sum, the bias sum, the
// normed q and k, the output), with products and sums rounded one at a time
// (__fmul_rn, __fadd_rn: no contraction into an FMA, as the chain's separate
// passes round each).  Only a row's sum of squares is added in another order
// (a lane's elements in turn, then a butterfly over the row's lanes), so a
// result differs from the plain chain's by at most an ulp of bf16 where the
// norm's factor rounds the other way.  Cosine and sine are the precise
// sincosf of float32 angles position * inv_freq, as torch.cos / torch.sin.
//
// Design:
//   * rms_norm_kernel<kV>: a row is `lanes` consecutive threads, each holding
//     kV 16-byte vectors (8 values each) in registers.  Rows of at most 256
//     values take a group of lanes inside a warp (a power of two: 16 lanes
//     for a 128-wide head row, 32 for 256), several rows a block, reduced by
//     shuffles; wider rows take a whole block (d = 2048: 256 threads of one
//     vector; d = 5120: 320 threads of two), reduced by shuffles and then
//     through shared memory.  The wrapper's `norm_plan` picks the layout
//     from the width.
//   * qk_rope_kernel: a block per token.  Its threads first compute the D/2
//     angles of the token's position once into shared memory (cos, sin),
//     then walk the token's H q rows and KV k rows, a group of D/16 lanes a
//     row (rounded up to a power of two): a lane holds the 8 values of the
//     first half and the 8 they rotate with in the second, so the rotation
//     needs no exchange between lanes; only the qk-norm's sum of squares
//     goes over the group.  q and k are read and written in place.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem_io.cuh"

namespace {

constexpr int kMaxHalf = 256;   // the widest rotated head: D = 512

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 8 values rounded to bf16, stored as 16 bytes (element 2j the low half)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]))) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 bf16 values from 16 bytes with a plain (coherent) load: for rows the
// same kernel writes
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  unpack16(*reinterpret_cast<const uint4*>(p), p, v);
}

__device__ __forceinline__ void load_f8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// v * r * (1 + w), each product rounded: the plain chain's y * (1 + scale)
__device__ __forceinline__ void scale8(float* v, float r, const float* w) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(__fmul_rn(v[e], r), __fadd_rn(1.f, w[e]));
}

template <int kV>
__global__ void __launch_bounds__(512)
rms_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                __nv_bfloat16* __restrict__ sum, long long rows, int d, int lanes, float eps) {
  __shared__ float part[32];
  const int nvec = d >> 3;
  const int lane = static_cast<int>(threadIdx.x) % lanes;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / lanes) +
                        threadIdx.x / lanes;
  const bool live = row < rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * d;
  float v[kV][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int c = lane + i * lanes;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[i][e] = 0.f;
    if (live && c < nvec) {
      load16(x + base + 8 * c, v[i]);
      if (res != nullptr) {   // residual + x, rounded as the bf16 add rounds it
        float r[8];
        load16(res + base + 8 * c, r);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = round_bf16(__fadd_rn(r[e], v[i][e]));
        store8(sum + base + 8 * c, v[i]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
  // the row's sum of squares: a butterfly over its lanes of a warp, then,
  // for a row of a whole block, the warps' sums in order from shared memory
  for (int off = (lanes < 32 ? lanes : 32) >> 1; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lanes > 32) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) ss += part[w];
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / d), eps));
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int c = lane + i * lanes;
    if (c < nvec) {
      float w[8];
      load_f8(scale + 8 * c, w);
      scale8(v[i], r, w);
      store8(y + base + 8 * c, v[i]);
    }
  }
}

__global__ void __launch_bounds__(512)
qk_rope_kernel(__nv_bfloat16* q, __nv_bfloat16* k, const long long* __restrict__ pos,
               long long pos_sb, long long pos_ss, int S, const float* __restrict__ inv_freq,
               const __nv_bfloat16* __restrict__ bq, const __nv_bfloat16* __restrict__ bk,
               const float* __restrict__ qn, const float* __restrict__ kn, int H, int KV, int D,
               int lanes, float eps) {
  __shared__ float cs[2 * kMaxHalf];   // cos of each frequency, then sin
  const long long t = blockIdx.x;
  const int half = D >> 1;
  {
    const long long b = t / S, s = t - b * S;
    const float p = static_cast<float>(pos[b * pos_sb + s * pos_ss]);
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      float sn, co;
      sincosf(__fmul_rn(p, inv_freq[i]), &sn, &co);
      cs[i] = co;
      cs[kMaxHalf + i] = sn;
    }
  }
  __syncthreads();
  const int nrows = H + KV;
  const int lane = static_cast<int>(threadIdx.x) % lanes;   // lanes: a power of two <= 32
  const int per_warp = 32 / lanes, per_block = blockDim.x / lanes;
  const bool lane_live = lane < (D >> 4);
  const int c1 = 8 * lane, c2 = half + 8 * lane;
  // h0 is the same for every lane of a warp, so each warp runs the loop (and
  // its shuffles) whole
  for (int h0 = static_cast<int>(threadIdx.x >> 5) * per_warp; h0 < nrows; h0 += per_block) {
    const int h = h0 + static_cast<int>(threadIdx.x & 31) / lanes;
    const bool live = lane_live && h < nrows;
    const bool isq = h < H;
    __nv_bfloat16* row = isq ? q + (static_cast<size_t>(t) * H + h) * D
                             : k + (static_cast<size_t>(t) * KV + (h - H)) * D;
    const __nv_bfloat16* bias = isq ? (bq ? bq + static_cast<size_t>(h) * D : nullptr)
                                    : (bk ? bk + static_cast<size_t>(h - H) * D : nullptr);
    const float* w = isq ? qn : kn;
    float a[8], c[8];
    float ss = 0.f;
    if (live) {
      load8(row + c1, a);
      load8(row + c2, c);
      if (bias != nullptr) {   // the projection's bias, rounded as the bf16 add rounds it
        float b1[8], b2[8];
        load16(bias + c1, b1);
        load16(bias + c2, b2);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a[e] = round_bf16(__fadd_rn(a[e], b1[e]));
          c[e] = round_bf16(__fadd_rn(c[e], b2[e]));
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(c[e], c[e], fmaf(a[e], a[e], ss));
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (!live) continue;
    if (w != nullptr) {   // the per-head RMSNorm, rounded to bf16 as the plain chain's output
      const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / D), eps));
      float w1[8], w2[8];
      load_f8(w + c1, w1);
      load_f8(w + c2, w2);
      scale8(a, r, w1);
      scale8(c, r, w2);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = round_bf16(a[e]), c[e] = round_bf16(c[e]);
    }
    float o1[8], o2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float co = cs[c1 + e], sn = cs[kMaxHalf + c1 + e];
      o1[e] = __fsub_rn(__fmul_rn(a[e], co), __fmul_rn(c[e], sn));
      o2[e] = __fadd_rn(__fmul_rn(c[e], co), __fmul_rn(a[e], sn));
    }
    store8(row + c1, o1);
    store8(row + c2, o2);
  }
}

}  // namespace

extern "C" int rms_norm_launch(const void* x, const void* res, const void* scale, void* y,
                               void* sum, long long rows, int d, int lanes, int threads,
                               int vec_per_lane, float eps, void* stream) {
  const long long per_block = threads / lanes;
  const unsigned grid = static_cast<unsigned>((rows + per_block - 1) / per_block);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  const auto* sp = static_cast<const float*>(scale);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* op = static_cast<__nv_bfloat16*>(sum);
  switch (vec_per_lane) {
#define NORM_CASE(V)                                                                  \
  case V:                                                                             \
    rms_norm_kernel<V><<<grid, threads, 0, st>>>(xp, rp, sp, yp, op, rows, d, lanes, eps); \
    break;
    NORM_CASE(1)
    NORM_CASE(2)
    NORM_CASE(4)
    NORM_CASE(8)
#undef NORM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qk_rope_launch(void* q, void* k, const void* pos, long long pos_sb,
                              long long pos_ss, const void* inv_freq, const void* bq,
                              const void* bk, const void* qn, const void* kn, long long tokens,
                              int S, int H, int KV, int D, int lanes, int threads, float eps,
                              void* stream) {
  if (D > 2 * kMaxHalf || 32 % lanes) return static_cast<int>(cudaErrorInvalidValue);
  qk_rope_kernel<<<static_cast<unsigned>(tokens), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
      static_cast<const long long*>(pos), pos_sb, pos_ss, S, static_cast<const float*>(inv_freq),
      static_cast<const __nv_bfloat16*>(bq), static_cast<const __nv_bfloat16*>(bk),
      static_cast<const float*>(qn), static_cast<const float*>(kn), H, KV, D, lanes, eps);
  return static_cast<int>(cudaGetLastError());
}
