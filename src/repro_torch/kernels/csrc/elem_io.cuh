// Element conversions shared by the kernels: f32 and bf16 inputs are read
// into fp32, outputs rounded back to their storage type.
//
// bf16 is the high half of an fp32 word, so a 16-byte load of eight bf16
// values unpacks with shifts and masks, low half first (little-endian).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes = kVec<T> elements, converted to fp32: unpack16 from a loaded
// uint4 (the pointer only picks the type), load16 from p (16-byte aligned)
template <typename T>
constexpr int kVec = 16 / sizeof(T);
__device__ __forceinline__ void unpack16(const uint4& x, const float*, float* out) {
  out[0] = __uint_as_float(x.x);
  out[1] = __uint_as_float(x.y);
  out[2] = __uint_as_float(x.z);
  out[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack16(const uint4& x, const __nv_bfloat16*, float* out) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // little-endian: element 2j is the low half
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), p, out);
}

}  // namespace
