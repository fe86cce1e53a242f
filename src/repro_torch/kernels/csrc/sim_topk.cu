// Masked cosine top-1 over gathered candidate rows, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   reuse_top1   <- repro/kernels/sim_topk.py::reuse_top1 (_reuse_top1_kernel,
//                   _gather_rows): raw slot-table candidates, unsorted, with
//                   duplicates, -1 = empty slot; a tie goes to the lowest row id.
//   gather_top1  <- repro/kernels/sim_topk.py::gather_top1 (_gather_top1_kernel):
//                   sorted, unique, front-packed candidates; a tie goes to the
//                   first position.
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

#include <cuda_runtime.h>
#include <math_constants.h>

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

}  // namespace

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
