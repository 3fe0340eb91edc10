// Page element loads shared by batch_paged_attention.cu and
// paged_flash_parts.cu (sm_90a).
//
// A page holds bf16, int8 (dequantized by the caller with its per-token
// scale) or float8 e4m3 elements. Each is widened to f32 exactly: bf16 and
// e4m3 are subsets of f32, and int8 levels are small integers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t5g_pages {

enum PageType : int { kBf16 = 0, kInt8 = 1, kE4m3 = 2 };

// 8 consecutive elements starting at element offset `off` (a multiple of
// 8): one 16-byte load of bf16, one 8-byte load of int8 or e4m3.
template <int PT>
__device__ __forceinline__ void load8(const void* base, int64_t off, float* out) {
  if constexpr (PT == kBf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(base) + off);
    const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(r[j]);
  } else if constexpr (PT == kInt8) {
    const int2 raw = *reinterpret_cast<const int2*>(
        reinterpret_cast<const int8_t*>(base) + off);
    const int8_t* r = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(r[j]);
  } else {
    const int2 raw = *reinterpret_cast<const int2*>(
        reinterpret_cast<const uint8_t*>(base) + off);
    const __nv_fp8_e4m3* r = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(r[j]);
  }
}

template <int PT>
__device__ __forceinline__ float load1(const void* base, int64_t off) {
  if constexpr (PT == kBf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[off]);
  } else if constexpr (PT == kInt8) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(base)[off]);
  } else {
    return static_cast<float>(reinterpret_cast<const __nv_fp8_e4m3*>(base)[off]);
  }
}

}  // namespace t5g_pages
