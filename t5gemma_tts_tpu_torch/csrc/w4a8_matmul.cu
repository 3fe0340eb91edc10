// W4A8 matrix product for Hopper (sm_90a): int8 activations times int4
// weights, the standalone entry point.
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/quant.py::_w4a8_kernel
// (reached through _w4a8_2d_pallas) and the XLA lanes4 product the JAX
// package takes elsewhere (_w4a8_2d_xla): every int4 product outside the
// decode-layer kernels (the head's w2 every decode step and at the
// speculative verify pass, the prefill and dense-cache projections).
//
// t5g_w4a8_matmul: quantizes x's rows into the caller's workspace, then
//                  out [M, N] = (f32(x8 @ q4^T) * sx) * sw, f32 or bf16,
//                  with q4 the int4 levels packed [N, K / 2]
//                  (ops/quant.py::Int4Weight): the GEMV of w8a8.cuh at
//                  M = 1 (the decode head, at about 60 % of its byte
//                  bound), the tensor-core product of w8a8_tc.cuh for
//                  M >= 2 (which needs K a multiple of 32).
// t5g_w4a8_plan: the int32 [splits, M, N] scratch t5g_w4a8_matmul needs
//                (0: none; -1: a shape it refuses) and, in plan[6] when
//                not null, the tensor-core tiling
//                (w8a8_tc.cuh::tc_describe; zeros on the GEMV route).
// The nibble unpacking, its exactness and the bounds are in w8a8.cuh and
// w8a8_tc.cuh.

#include "w8a8.cuh"
#include "w8a8_tc.cuh"

extern "C" int t5g_w4a8_plan(int M, int N, int K, int* plan) {
  if (M <= 1) {
    for (int i = 0; plan != nullptr && i < 6; ++i) plan[i] = 0;
    return 0;
  }
  return t5g::tc_describe<true>(M, N, K, plan);
}

extern "C" int t5g_w4a8_matmul(const void* x, int x_is_bf16, int M, int K, const int8_t* w,
                               const float* sw, int N, void* out, int out_is_bf16,
                               int8_t* x8, float* sx, int32_t* part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_is_bf16 ? t5g::launch_quantize_rows(static_cast<const __nv_bfloat16*>(x), K, M, K, x8, sx, s)
                : t5g::launch_quantize_rows(static_cast<const float*>(x), K, M, K, x8, sx, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (M <= 1) {
    t5g::GemvArgs p{x8, sx, w, sw, out, M, N, K, K};
    return static_cast<int>(out_is_bf16 ? t5g::launch_gemv<__nv_bfloat16, true>(p, s)
                                        : t5g::launch_gemv<float, true>(p, s));
  }
  return static_cast<int>(
      t5g::launch_tc<true>(x8, sx, w, sw, out, out_is_bf16, part, M, N, K, s));
}

// A rank's row-split block (w8a8_matmul.cu's t5g_w8a8_int, on this
// product's routes): the exact int32 sums of x8 and the int4 levels [M, N].
extern "C" int t5g_w4a8_int(const int8_t* x8, int M, int K, const int8_t* w, int N,
                            int32_t* out, int32_t* part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) {
    t5g::GemvIntArgs p{x8, w, out, M, N, K, 0, K, 1};
    return static_cast<int>(t5g::launch_gemv_int<true>(p, s));
  }
  return static_cast<int>(t5g::launch_tc<true>(x8, nullptr, w, nullptr, out, t5g::kOutInt32,
                                               part, M, N, K, s));
}
