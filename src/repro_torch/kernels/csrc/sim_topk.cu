// Masked cosine top-1 over gathered candidate rows, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   reuse_top1   <- repro/kernels/sim_topk.py::reuse_top1 (_reuse_top1_kernel,
//                   _gather_rows): raw slot-table candidates, unsorted, with
//                   duplicates, -1 = empty slot; a tie goes to the lowest row id.
//   gather_top1  <- repro/kernels/sim_topk.py::gather_top1 (_gather_top1_kernel):
//                   sorted, unique, front-packed candidates; a tie goes to the
//                   first position.
//   sim_top1     <- repro/kernels/sim_topk.py::sim_top1 (_sim_top1_kernel):
//                   brute-force top-1 over a whole (N, D) store, f32 or bf16,
//                   rows at or after n_valid masked; a tie goes to the first
//                   index.  Design notes at its kernel below.
//
// What bounds it: each candidate costs one D-float row gathered from the
// store (random rows) for 2*D fp32 FLOP.  At the serving shapes (B=1024
// queries x C=20480 candidates x D=64) that is 5.4 GB of row reads for
// 2.7 GFLOP, so the kernel is bound by the gather traffic, not by the
// arithmetic; a 100k x 64 store (25.6 MB) stays resident in the 50 MB L2, so
// the rows mostly come from L2 rather than HBM.
//
// Design:
//   * One block per query row; the loop over the candidate axis runs inside
//     the block (the TPU kernel carried a running best across a sequential
//     grid axis; Hopper blocks run in parallel, so nothing is carried between
//     blocks).  The query row sits in shared memory and is read as a
//     broadcast; candidate ids are read coalesced; each thread gathers whole
//     rows with 16-byte loads.
//   * Every candidate's dot product runs through one code path (dot_row) in
//     one fixed order over D with explicit fmaf, so duplicate ids and equal
//     rows score bit-equal.  The lowest-id-among-maxima rule depends on that.
//   * The running best is lexicographic (max value, then min key) and is
//     reduced with warp shuffles and shared memory.  The reduction is
//     order-free, so the parallel lanes give the sequential grid's answer.
//   * The store is addressed as (num_pages, page_size, D): a slot id maps to
//     page min(id / page_size, num_pages - 1), offset id % page_size, as the
//     Pallas kernel does.  A flat (N, D) store is passed as page_size = 1,
//     num_pages = N, which gives jnp.take's mode="clip" row min(id, N - 1).
//   * Plain fp32 FMA on the CUDA cores, no TF32: winners must not flip
//     against the reference's fp32 arithmetic.
#include <climits>
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "elem_io.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool better(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

// One fixed summation order over D for every candidate (see the note above).
__device__ __forceinline__ float dot_row(const float* q, const float* __restrict__ row,
                                         int d) {
  float acc = 0.f;
  if ((d & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int e = 0; e < d / 4; ++e) {
      const float4 r = __ldg(r4 + e);
      acc = fmaf(q[4 * e], r.x, acc);
      acc = fmaf(q[4 * e + 1], r.y, acc);
      acc = fmaf(q[4 * e + 2], r.z, acc);
      acc = fmaf(q[4 * e + 3], r.w, acc);
    }
  } else {
    for (int e = 0; e < d; ++e) acc = fmaf(q[e], __ldg(row + e), acc);
  }
  return acc;
}

__device__ __forceinline__ void warp_best(float& v, int& k) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int ok = __shfl_down_sync(0xffffffffu, k, o);
    if (better(ov, ok, v, k)) {
      v = ov;
      k = ok;
    }
  }
}

// kByPosition: key = candidate position (gather_top1), else key = row id
// (reuse_top1).
template <bool kByPosition>
__global__ void __launch_bounds__(kThreads)
top1_kernel(const float* __restrict__ q, const int* __restrict__ ids,
            const float* __restrict__ store, float* __restrict__ out_val,
            int* __restrict__ out_idx, int C, int D, int num_pages, int page_size) {
  extern __shared__ float q_sh[];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_k[kThreads / 32];

  const int row = blockIdx.x;
  const float* qr = q + static_cast<size_t>(row) * D;
  for (int e = threadIdx.x; e < D; e += blockDim.x) q_sh[e] = qr[e];
  __syncthreads();

  const int* ir = ids + static_cast<size_t>(row) * C;
  float bv = -CUDART_INF_F;
  int bk = INT_MAX;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int id = ir[c];
    if (id < 0) continue;
    const int pg = min(id / page_size, num_pages - 1);
    const float* r = store + (static_cast<size_t>(pg) * page_size + id % page_size) * D;
    const float s = dot_row(q_sh, r, D);
    const int key = kByPosition ? c : id;
    if (better(s, key, bv, bk)) {
      bv = s;
      bk = key;
    }
  }

  warp_best(bv, bk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = bv;
    red_k[warp] = bk;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    bv = lane < nw ? red_v[lane] : -CUDART_INF_F;
    bk = lane < nw ? red_k[lane] : INT_MAX;
    warp_best(bv, bk);
    if (lane == 0) {
      const bool found = bv > -CUDART_INF_F;
      out_val[row] = bv;
      out_idx[row] = !found ? -1 : (kByPosition ? ir[bk] : bk);
    }
  }
}

template <bool kByPosition>
int launch(const float* q, const int* ids, const float* store, float* val, int* idx,
           int Q, int C, int D, int num_pages, int page_size, void* stream) {
  if (Q > 0) {
    top1_kernel<kByPosition>
        <<<Q, kThreads, D * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
            q, ids, store, val, idx, C, D, num_pages, page_size);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ sim_top1
// What bounds it: 2*D FLOP per (query, store row) pair against one read of
// the store, so at Q = 4096 queries over 250k x 64 rows (131 GFLOP, 64 MB)
// it is bound by the fp32 rate of the CUDA cores (2 ms at 67 TFLOP/s), not
// by HBM.  The TPU kernel streamed the store through VMEM with a running
// (best, index) carried across a sequential grid axis.  Here:
//   * A block takes 64 queries (kept in shared memory) and one split of the
//     store's rows, walking it in tiles of 64 rows staged transposed in
//     shared memory; each thread scores 4 queries x 4 rows per tile with
//     fp32 FMA and keeps a lexicographic (max score, min index) best per
//     query.  That pair is order-free, so it equals the TPU kernel's
//     first-max-wins rule (argmax within a tile, strict > across tiles).
//   * Splitting the rows over blocks fills the 132 SMs when there are few
//     query tiles; a second kernel merges the splits with the same rule.
//   * Scores are plain dots: like the TPU kernel, this one does not
//     normalise (the store holds unit rows).
constexpr int kSimRows = 64, kSimCols = 64, kSimThreads = 256;
constexpr int kStStride = kSimCols + 1;

template <typename T>
__global__ void __launch_bounds__(kSimThreads)
sim_top1_kernel(const T* __restrict__ q, const T* __restrict__ store,
                float* __restrict__ part_val, int* __restrict__ part_idx, int Q, int D,
                int n_valid, int chunk) {
  extern __shared__ float sm[];
  const int qstride = D + 4;             // rows 16 bytes apart in bank order
  float* Qs = sm;                        // [kSimRows][D + 4]
  float* St = Qs + kSimRows * qstride;   // [D][kStStride], store rows transposed
  const int q0 = blockIdx.x * kSimRows, split = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c_begin = split * chunk, c_end = min(c_begin + chunk, n_valid);

  for (int i = tid; i < kSimRows * D; i += kSimThreads) {
    const int r = i / D, d = i - r * D;
    Qs[r * qstride + d] = q0 + r < Q ? to_f(q[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }
  float bv[4];
  int bi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bv[i] = -CUDART_INF_F;
    bi[i] = INT_MAX;
  }
  for (int c0 = c_begin; c0 < c_end; c0 += kSimCols) {
    __syncthreads();
    for (int i = tid; i < kSimCols * D; i += kSimThreads) {
      const int c = i / D, d = i - c * D;
      St[d * kStStride + c] =
          c0 + c < c_end ? to_f(store[static_cast<size_t>(c0 + c) * D + d]) : 0.f;
    }
    __syncthreads();
    float s[4][4] = {};
    for (int d = 0; d < D; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * qstride + d);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = St[(d + dd) * kStStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = dd == 0 ? a[i].x : dd == 1 ? a[i].y : dd == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ai, b[j], s[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= c_end) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (better(s[i][j], col, bv[i], bi[i])) {
          bv[i] = s[i][j];
          bi[i] = col;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {   // the 16 threads of a half-warp
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int ok = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (better(ov, ok, bv[i], bi[i])) {
        bv[i] = ov;
        bi[i] = ok;
      }
    }
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < Q) {
      part_val[static_cast<size_t>(split) * Q + row] = bv[i];
      part_idx[static_cast<size_t>(split) * Q + row] = bi[i];
    }
  }
}

// One thread per query: merge the splits; a query with no valid row gets
// (-inf, 0), the TPU kernel's initial best.
__global__ void sim_top1_combine(const float* __restrict__ part_val,
                                 const int* __restrict__ part_idx, float* __restrict__ val,
                                 int* __restrict__ idx, int Q, int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Q) return;
  float bv = -CUDART_INF_F;
  int bk = INT_MAX;
  for (int s = 0; s < n_split; ++s) {
    const float v = part_val[static_cast<size_t>(s) * Q + row];
    const int k = part_idx[static_cast<size_t>(s) * Q + row];
    if (better(v, k, bv, bk)) {
      bv = v;
      bk = k;
    }
  }
  val[row] = bv;
  idx[row] = bv > -CUDART_INF_F ? bk : 0;
}

template <typename T>
int sim_launch(const void* q, const void* store, float* val, int* idx, float* part_val,
               int* part_idx, int Q, int D, int n_valid, int n_split, int chunk,
               cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(float) * (kSimRows * (D + 4) + D * kStStride));
  cudaError_t err = cudaFuncSetAttribute(
      sim_top1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + kSimRows - 1) / kSimRows, n_split);
  sim_top1_kernel<T><<<grid, kSimThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(store), part_val, part_idx, Q, D,
      n_valid, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sim_top1_combine<<<(Q + 255) / 256, 256, 0, stream>>>(part_val, part_idx, val, idx, Q,
                                                      n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (Q, D), store (N, D) contiguous, both f32 or both bf16, D % 4 == 0;
// rows >= n_valid (<= N) score -inf.  Scratch part_val / part_idx hold
// (n_split, Q); split s covers rows [s * chunk, (s + 1) * chunk).
extern "C" int sim_top1_launch(const void* q, const void* store, float* val, int* idx,
                               float* part_val, int* part_idx, int Q, int D, int n_valid,
                               int n_split, int chunk, int is_bf16, void* stream) {
  if (Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? sim_launch<__nv_bfloat16>(q, store, val, idx, part_val, part_idx, Q, D,
                                             n_valid, n_split, chunk, s)
                 : sim_launch<float>(q, store, val, idx, part_val, part_idx, Q, D, n_valid,
                                     n_split, chunk, s);
}

extern "C" int reuse_top1_launch(const float* q, const int* ids, const float* store,
                                 float* val, int* idx, int Q, int C, int D,
                                 int num_pages, int page_size, void* stream) {
  return launch<false>(q, ids, store, val, idx, Q, C, D, num_pages, page_size, stream);
}

extern "C" int gather_top1_launch(const float* q, const int* ids, const float* store,
                                  float* val, int* idx, int Q, int C, int D,
                                  int num_pages, int page_size, void* stream) {
  return launch<true>(q, ids, store, val, idx, Q, C, D, num_pages, page_size, stream);
}
