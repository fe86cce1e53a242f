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
// Design:
//   * One block per (batch tile of kTileB rows, table t), one thread per row.
//     The loop over the K rotations runs inside the block and carries the
//     int32 mix accumulator acc = (acc * 2D + vid) % num_buckets in a
//     register; it replaces the TPU kernel's sequential K grid axis, whose
//     output block stayed resident across steps.
//   * The x tile (row stride D + 1, so the threads' reads fall in distinct
//     banks) and the current (D, D) rotation sit in shared memory; rotation
//     reads are broadcasts.
//   * proj[d] = sum_e R[d, e] x[e] in a fixed order with explicit fmaf.  The
//     vertex is the FIRST maximum of concat([proj, -proj]), the order of
//     LSH.hash_batch: +e_v wins an exact tie against -e_w (the Pallas kernel's
//     argmax|proj| + sign bit differs from it only on such a tie).
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int kTileB = 64;

template <bool kMix>
__global__ void __launch_bounds__(kTileB)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ rot,
                int* __restrict__ out, int B, int D, int T, int K, int num_buckets) {
  extern __shared__ float sh[];
  float* r_sh = sh;             // (D, D) rotation R[t, k]
  float* x_sh = sh + D * D;     // (kTileB, D + 1) input rows
  const int ld = D + 1;
  const int t = blockIdx.y;
  const int b0 = blockIdx.x * kTileB;

  for (int i = threadIdx.x; i < kTileB * D; i += blockDim.x) {
    const int rr = i / D, e = i - rr * D;
    const int b = b0 + rr;
    x_sh[rr * ld + e] = b < B ? x[static_cast<size_t>(b) * D + e] : 0.f;
  }

  const int b = b0 + threadIdx.x;
  const float* xr = x_sh + threadIdx.x * ld;
  int acc = 0;
  for (int k = 0; k < K; ++k) {
    __syncthreads();  // x tile loaded / previous rotation no longer read
    const float* rg = rot + (static_cast<size_t>(t) * K + k) * D * D;
    for (int i = threadIdx.x; i < D * D; i += blockDim.x) r_sh[i] = rg[i];
    __syncthreads();

    float pos_v = 0.f, neg_v = 0.f;
    int pos_i = 0, neg_i = 0;
    for (int d = 0; d < D; ++d) {
      const float* rd = r_sh + d * D;
      float p = 0.f;
      for (int e = 0; e < D; ++e) p = fmaf(rd[e], xr[e], p);
      if (d == 0 || p > pos_v) {
        pos_v = p;
        pos_i = d;
      }
      if (d == 0 || -p > neg_v) {
        neg_v = -p;
        neg_i = d;
      }
    }
    const int vid = neg_v > pos_v ? D + neg_i : pos_i;
    if (kMix) {
      acc = (acc * 2 * D + vid) % num_buckets;
    } else if (b < B) {
      out[(static_cast<size_t>(b) * T + t) * K + k] = vid;
    }
  }
  if (kMix && b < B) out[static_cast<size_t>(b) * T + t] = acc;
}

template <bool kMix>
int launch(const float* x, const float* rot, int* out, int B, int D, int T, int K,
           int num_buckets, void* stream) {
  const size_t smem = (static_cast<size_t>(D) * D + static_cast<size_t>(kTileB) * (D + 1)) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsh_hash_kernel<kMix>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0 && T > 0) {
    const dim3 grid((B + kTileB - 1) / kTileB, T);
    lsh_hash_kernel<kMix><<<grid, kTileB, smem, static_cast<cudaStream_t>(stream)>>>(
        x, rot, out, B, D, T, K, num_buckets);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsh_hash_mix_launch(const float* x, const float* rot, int* out, int B, int D,
                                   int T, int K, int num_buckets, void* stream) {
  return launch<true>(x, rot, out, B, D, T, K, num_buckets, stream);
}

extern "C" int lsh_hash_launch(const float* x, const float* rot, int* out, int B, int D,
                               int T, int K, void* stream) {
  return launch<false>(x, rot, out, B, D, T, K, 1, stream);
}
