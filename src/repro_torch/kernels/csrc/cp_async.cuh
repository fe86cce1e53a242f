// Asynchronous copies global -> shared memory (cp.async, sm_80 and later):
// issue many, commit them as a group, wait for all but the newest N groups.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// a copy of kBytes = 16 needs both addresses on a 16-byte boundary
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// kBytes-wide copy: 16 (both addresses 16-byte aligned) or 4
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kBytes / 4 zero floats at dst
template <int kBytes>
__device__ __forceinline__ void zero(float* dst) {
  if constexpr (kBytes == 16) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    *dst = 0.f;
  }
}

}  // namespace
