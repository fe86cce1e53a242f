// Cross-polytope LSH hashing, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   lsh_hash_mix <- repro/kernels/lsh_hash.py::lsh_hash_mix (_lsh_hash_mix_kernel):
//                   (B, D) x (T, K, D, D) -> (B, T) mixed bucket ids.
//   lsh_hash     <- repro/kernels/lsh_hash.py::lsh_hash (_lsh_hash_kernel):
//                   the same vertex ids, unmixed, (B, T, K).
//
// What bounds it: 2 * B * T * K * D * D fp32 FLOP over B * D + T * K * D * D
// input floats, i.e. about D / 2 FLOP per byte at K = 1: the arithmetic, not
// the memory, bounds it on this card (fp32 on the CUDA cores, no TF32, so a
// vertex never flips against the reference's fp32 hash).
//
// Design (register-tiled; the wrapper's ``launch_plan`` picks the shapes):
//   * One block per (tile of 16 * kRI rows, table t), 256 threads: 16 row
//     groups of 16 lanes.  Lane `sub` of group g computes the projections
//     d = sub + 16 j (j < kJ) of rows g + 16 i (i < kRI), a kRI x kJ register
//     tile, reading x and R as 16-byte shared-memory vectors.  The wrapper
//     takes the largest kRI of 4, 2, 1 (64-, 32-, 16-row tiles) that still
//     gives 132 blocks: a routed batch of 1024 over 5 tables fills the card
//     with 160 blocks of 32 rows, a batch of 4096 with 320 of 64, each
//     reading its rotation for twice the rows.
//   * The x tile and a slab of 16 * kJ rows of R[t, k] sit in shared memory
//     (rows D + 4 floats apart, so 8 lanes' 16-byte reads fall in distinct
//     banks), staged with cp.async copies that are all in flight at once;
//     D > 128 walks R in slabs.  The loop over the K rotations runs
//     inside the block and carries acc = (acc * 2D + vid) % num_buckets in a
//     register, in order; it replaces the TPU kernel's sequential K grid axis.
//   * proj[d] = sum_e R[d, e] x[e] as one fmaf chain in ascending e from 0,
//     the same value whichever lane or tile computes it (zero columns that
//     pad D to a multiple of 4 add fmaf(0, 0, p) = p).
//   * The vertex is the FIRST maximum of concat([proj, -proj]), the order of
//     LSH.hash_batch: a lexicographic (max value, min key) over the row's 16
//     lanes and their slabs, key d for +proj[d] and D + d for -proj[d],
//     reduced with shuffles.  +e_v wins an exact tie against -e_w (the Pallas
//     kernel's argmax|proj| + sign bit differs from it only on such a tie).
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "cp_async.cuh"

namespace {

constexpr int kLanes = 16, kGroups = 16, kThreads = kLanes * kGroups;
constexpr int kMaxDevices = 64;

// Copy n rows of D floats (row stride D in global) into shared rows of stride
// ld; rows at or past n_valid are zero.  All copies in flight at once.
template <int kBytes>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int n,
                                           int n_valid, int D, int ld) {
  constexpr int kW = kBytes / 4;
  const int nc = D / kW;
  for (int i = threadIdx.x; i < n * nc; i += kThreads) {
    const int r = i / nc, c = i - r * nc;
    float* d = dst + r * ld + c * kW;
    if (r < n_valid) {
      cp_async<kBytes>(d, src + static_cast<size_t>(r) * D + c * kW);
    } else {
      zero<kBytes>(d);
    }
  }
  cp_commit();
  cp_wait<0>();
}

__device__ __forceinline__ void take(float v, int key, float& bv, int& bk) {
  if (v > bv || (v == bv && key < bk)) {
    bv = v;
    bk = key;
  }
}

template <int kRI, int kJ, bool kMix, int kBytes>
__global__ void __launch_bounds__(kThreads)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ rot,
                int* __restrict__ out, int B, int D, int T, int K, int num_buckets) {
  constexpr int kRows = kRI * kGroups, kSlab = kJ * kLanes;
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const int dp = (D + 3) & ~3, ld = dp + 4;
  float* xs = sh;                 // [kRows][ld] input rows
  float* rs = sh + kRows * ld;    // [kSlab][ld] rows d0 .. d0 + kSlab of R[t, k]
  const int t = blockIdx.y, b0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, g = tid / kLanes, sub = tid % kLanes;

  if (dp != D) {                 // columns D .. dp of both tiles stay 0
    for (int i = tid; i < (kRows + kSlab) * (dp - D); i += kThreads) {
      const int r = i / (dp - D);
      sh[r * ld + D + i - r * (dp - D)] = 0.f;
    }
  }
  stage_rows<kBytes>(xs, x + static_cast<size_t>(b0) * D, kRows, B - b0, D, ld);
  int acc[kRI] = {};
  for (int k = 0; k < K; ++k) {
    const float* rg = rot + (static_cast<size_t>(t) * K + k) * D * D;
    float bv[kRI];
    int bk[kRI];
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      bv[i] = -CUDART_INF_F;
      bk[i] = INT_MAX;
    }
    for (int d0 = 0; d0 < D; d0 += kSlab) {
      __syncthreads();   // x tile staged / the previous slab no longer read
      stage_rows<kBytes>(rs, rg + static_cast<size_t>(d0) * D, kSlab, D - d0, D, ld);
      __syncthreads();
      float p[kRI][kJ] = {};
      for (int e = 0; e < dp; e += 4) {
        float4 xv[kRI], rv[kJ];
#pragma unroll
        for (int i = 0; i < kRI; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xs + (g + kGroups * i) * ld + e);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          rv[j] = *reinterpret_cast<const float4*>(rs + (sub + kLanes * j) * ld + e);
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            p[i][j] = fmaf(rv[j].x, xv[i].x, p[i][j]);
            p[i][j] = fmaf(rv[j].y, xv[i].y, p[i][j]);
            p[i][j] = fmaf(rv[j].z, xv[i].z, p[i][j]);
            p[i][j] = fmaf(rv[j].w, xv[i].w, p[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = d0 + sub + kLanes * j;
        if (d >= D) continue;
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
          take(p[i][j], d, bv[i], bk[i]);
          take(-p[i][j], D + d, bv[i], bk[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {   // the row's 16 lanes
        const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
        const int ok = __shfl_xor_sync(0xffffffffu, bk[i], off);
        take(ov, ok, bv[i], bk[i]);
      }
      const int b = b0 + g + kGroups * i;
      if (kMix) {
        acc[i] = (acc[i] * 2 * D + bk[i]) % num_buckets;
      } else if (sub == 0 && b < B) {
        out[(static_cast<size_t>(b) * T + t) * K + k] = bk[i];
      }
    }
  }
  if (kMix && sub == 0) {
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int b = b0 + g + kGroups * i;
      if (b < B) out[static_cast<size_t>(b) * T + t] = acc[i];
    }
  }
}

template <int kRI, int kJ, bool kMix, int kBytes>
int launch(const float* x, const float* rot, int* out, int B, int D, int T, int K,
           int num_buckets, int smem_bytes, cudaStream_t stream) {
  constexpr int kRows = kRI * kGroups, kSlab = kJ * kLanes;
  if (smem_bytes != (kRows + kSlab) * (((D + 3) & ~3) + 4) * static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the shared-memory limit, raised once a (kernel, device): the call costs
  // more host time than the kernel itself
  static int smem_set[kMaxDevices] = {};
  int& set = smem_set[dev % kMaxDevices];
  if (smem_bytes > set) {
    err = cudaFuncSetAttribute(lsh_hash_kernel<kRI, kJ, kMix, kBytes>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set = smem_bytes;
  }
  if (B > 0 && T > 0) {
    const dim3 grid((B + kRows - 1) / kRows, T);
    lsh_hash_kernel<kRI, kJ, kMix, kBytes><<<grid, kThreads, smem_bytes, stream>>>(
        x, rot, out, B, D, T, K, num_buckets);
  }
  return static_cast<int>(cudaGetLastError());
}

// row_slots (kRI) in {1, 2, 4}, proj_per_lane (kJ) in {2, 4, 8}: the plan's shapes
template <bool kMix>
int dispatch(const float* x, const float* rot, int* out, int B, int D, int T, int K,
             int num_buckets, int row_slots, int proj_per_lane, int smem_bytes,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every row starts on 16 bytes, else 4-byte ones
  const bool vec16 = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rot) % 16 == 0;
#define LSH_CASE(RI, J)                                                                 \
  if (row_slots == RI && proj_per_lane == J)                                            \
    return vec16                                                                        \
               ? launch<RI, J, kMix, 16>(x, rot, out, B, D, T, K, num_buckets, smem_bytes, s) \
               : launch<RI, J, kMix, 4>(x, rot, out, B, D, T, K, num_buckets, smem_bytes, s);
  LSH_CASE(1, 2) LSH_CASE(1, 4) LSH_CASE(1, 8)
  LSH_CASE(2, 2) LSH_CASE(2, 4) LSH_CASE(2, 8)
  LSH_CASE(4, 2) LSH_CASE(4, 4) LSH_CASE(4, 8)
#undef LSH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int lsh_hash_mix_launch(const float* x, const float* rot, int* out, int B, int D,
                                   int T, int K, int num_buckets, int row_slots,
                                   int proj_per_lane, int smem_bytes, void* stream) {
  return dispatch<true>(x, rot, out, B, D, T, K, num_buckets, row_slots, proj_per_lane,
                        smem_bytes, stream);
}

extern "C" int lsh_hash_launch(const float* x, const float* rot, int* out, int B, int D,
                               int T, int K, int row_slots, int proj_per_lane,
                               int smem_bytes, void* stream) {
  return dispatch<false>(x, rot, out, B, D, T, K, 1, row_slots, proj_per_lane, smem_bytes,
                         stream);
}
