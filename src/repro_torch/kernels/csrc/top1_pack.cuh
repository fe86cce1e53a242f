// The order-free top-1 merge shared by the top-1 kernels (sim_topk.cu,
// reuse_probed.cu): a best is the lexicographic (max score, min key), and a
// block hands its best to the others as one 64-bit key, (orderable score
// bits) << 32 | (0xFFFFFFFF - key), through atomicMax.  The max of such keys
// does not depend on the order in which blocks arrive, so parallel blocks
// give the sequential grid's answer.
//
// The key is a row id (reuse_top1, both routes: the lowest id wins a tie), a
// candidate position (gather_top1: the first position wins) or a store index
// (sim_top1: the first index wins).  -0.0 is packed as +0.0: the two compare
// equal, so they must tie.  Only a best that `better` accepted is packed, so
// a NaN score never enters a key.  The top-1 kernels also share the raise of
// a kernel's shared-memory limit (smem_limit).
#pragma once

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ bool better(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

__device__ __forceinline__ unsigned long long pack(float v, int key) {
  unsigned u = __float_as_uint(v == 0.f ? 0.f : v);   // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);      // orderable as unsigned
  return (static_cast<unsigned long long>(u) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(key));
}

__device__ __forceinline__ float unpack_val(unsigned long long k) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi);
}

__device__ __forceinline__ int unpack_key(unsigned long long k) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k));
}

// (value, key) best of a group of kWidth lanes (xor shuffles: every lane of
// the group ends with the group's best)
template <int kWidth>
__device__ __forceinline__ void group_best(float& v, int& k) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int ok = __shfl_xor_sync(0xffffffffu, k, o);
    if (better(ov, ok, v, k)) {
      v = ov;
      k = ok;
    }
  }
}

// Merge a lane's best into keys[slot] (a best that was never set is skipped).
__device__ __forceinline__ void merge_best(unsigned long long* keys, int slot, float v, int k) {
  if (k != INT_MAX) atomicMax(keys + slot, pack(v, k));
}

// One thread per query: packed key -> (score, index).  No key (0), or a best
// of -inf, gives (-inf, empty).  With positions != nullptr the key is a
// position in row b of positions (B, C) and the index is the id stored there;
// else the key is the index itself.
__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              const int* __restrict__ positions, int C,
                              float* __restrict__ val, int* __restrict__ idx, int B, int empty) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const unsigned long long k = keys[b];
  const float v = k == 0ull ? -CUDART_INF_F : unpack_val(k);
  val[b] = v;
  if (!(v > -CUDART_INF_F)) {
    idx[b] = empty;
    return;
  }
  const int key = unpack_key(k);
  idx[b] = positions != nullptr ? positions[static_cast<size_t>(b) * C + key] : key;
}

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit to `bytes` once a device
// (`done`: one static array per kernel): the call costs more host time than
// the launch itself.
template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && bytes > done[dev % kMaxDevices]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done[dev % kMaxDevices] = bytes;
  }
  return err;
}

inline cudaError_t unpack(const unsigned long long* keys, const int* positions, int C,
                          float* val, int* idx, int B, int empty, cudaStream_t s) {
  unpack_kernel<<<(B + 255) / 256, 256, 0, s>>>(keys, positions, C, val, idx, B, empty);
  return cudaGetLastError();
}

}  // namespace
