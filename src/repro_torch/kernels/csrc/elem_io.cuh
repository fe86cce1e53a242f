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

// 16 bytes = kVec<T> elements, converted to fp32 (p must be 16-byte aligned)
template <typename T>
constexpr int kVec = 16 / sizeof(T);
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // little-endian: element 2j is the low half
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

}  // namespace
