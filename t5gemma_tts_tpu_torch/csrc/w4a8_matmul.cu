// W4A8 matrix product for Hopper (sm_90a): int8 activations times int4
// weights, the standalone entry point.
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/quant.py::_w4a8_kernel
// (reached through _w4a8_2d_pallas) and the XLA lanes4 product the JAX
// package takes elsewhere (_w4a8_2d_xla): every int4 product outside the
// decode-layer kernels (the head's w2 every decode step, the prefill and
// dense-cache projections).
//
// t5g_w4a8_matmul: quantizes x's rows into the caller's workspace, then
//                  out [M, N] = (f32(x8 @ q4^T) * sx) * sw, f32 or bf16,
//                  with q4 the int4 levels packed [N, K / 2]
//                  (ops/quant.py::Int4Weight).
// The device code (shared with the W8A8 product and the decode layer), its
// nibble unpacking, its exactness and its bound are in w8a8.cuh: the
// product reads half the weight bytes of W8A8 and is bound by them.

#include "w8a8.cuh"

extern "C" int t5g_w4a8_matmul(const void* x, int x_is_bf16, int M, int K, const int8_t* w,
                               const float* sw, int N, void* out, int out_is_bf16,
                               int8_t* x8, float* sx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_is_bf16 ? t5g::launch_quantize_rows(static_cast<const __nv_bfloat16*>(x), K, M, K, x8, sx, s)
                : t5g::launch_quantize_rows(static_cast<const float*>(x), K, M, K, x8, sx, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  t5g::GemvArgs p{x8, sx, w, sw, out, M, N, K, K};
  return static_cast<int>(out_is_bf16 ? t5g::launch_gemv<__nv_bfloat16, true>(p, s)
                                      : t5g::launch_gemv<float, true>(p, s));
}
