// W8A8 matrix product for Hopper (sm_90a): the standalone entry points.
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/quant.py::_w8a8_kernel
// (reached through _w8a8_core / _w8a8_2d_pallas) and, since the card has no
// int8 matmul in PyTorch, also the XLA int8 dot the JAX package takes by
// default (_w8a8_2d_xla): every int8 product outside the decode-layer
// kernel (cross K/V, prefill projections, the head's w1 and w2).
//
// t5g_quantize_rows: x [M, K] f32/bf16 -> x8 [M, K] int8, sx [M] f32.
// t5g_w8a8_matmul:   quantizes x's rows into the caller's workspace, then
//                    out [M, N] = (f32(x8 @ w8^T) * sx) * sw, f32 or bf16:
//                    the GEMV of w8a8.cuh for M <= 16 (the decode head: a
//                    weight stream at about half its byte bound), the
//                    tensor-core product of w8a8_tc.cuh above.
// t5g_w8a8_plan:     the int32 [splits, M, N] scratch t5g_w8a8_matmul needs
//                    (0: none; -1: a shape it refuses) and, in plan[6] when
//                    not null, the tensor-core tiling
//                    (w8a8_tc.cuh::tc_describe; zeros on the GEMV route).
// t5g_w8a8_gemv:     the GEMV route at any M, int8 or (w4) packed int4
//                    weights; no caller on the main path (a yardstick).
//
// A rank's row-split block under tensor parallelism (w8a8.cuh), the
// all-reduces between the calls:
// t5g_row_absmax:    amax [M] of x's rows;
// t5g_quantize_rows_amax: x8 and sx [M] at the group's amax [M];
// t5g_w8a8_int:      the exact int32 sums x8 @ w8^T [M, N], on the routes
//                    of t5g_w8a8_matmul (part: its split-K scratch);
// t5g_rescale_rows:  out = (f32(acc) * sx) * sw on the group's sums.

#include "w8a8.cuh"
#include "w8a8_tc.cuh"

namespace {
constexpr int kGemvRows = 16;   // the GEMV takes M <= 16, tensor cores above
}

extern "C" int t5g_quantize_rows(const void* x, int x_is_bf16, int M, int K, int8_t* x8,
                                 float* sx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_is_bf16 ? t5g::launch_quantize_rows(static_cast<const __nv_bfloat16*>(x), K, M, K, x8, sx, s)
                : t5g::launch_quantize_rows(static_cast<const float*>(x), K, M, K, x8, sx, s);
  return static_cast<int>(e);
}

extern "C" int t5g_w8a8_plan(int M, int N, int K, int* plan) {
  if (M <= kGemvRows) {
    for (int i = 0; plan != nullptr && i < 6; ++i) plan[i] = 0;
    return 0;
  }
  return t5g::tc_describe<false>(M, N, K, plan);
}

extern "C" int t5g_w8a8_gemv(const void* x, int x_is_bf16, int M, int K, const int8_t* w,
                             const float* sw, int N, void* out, int out_is_bf16, int8_t* x8,
                             float* sx, int w4, void* stream) {
  const int e = t5g_quantize_rows(x, x_is_bf16, M, K, x8, sx, stream);
  if (e != 0) return e;
  t5g::GemvArgs p{x8, sx, w, sw, out, M, N, K, K};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w4)
    return static_cast<int>(out_is_bf16 ? t5g::launch_gemv<__nv_bfloat16, true>(p, s)
                                        : t5g::launch_gemv<float, true>(p, s));
  return static_cast<int>(out_is_bf16 ? t5g::launch_gemv<__nv_bfloat16>(p, s)
                                      : t5g::launch_gemv<float>(p, s));
}

extern "C" int t5g_w8a8_matmul(const void* x, int x_is_bf16, int M, int K, const int8_t* w,
                               const float* sw, int N, void* out, int out_is_bf16,
                               int8_t* x8, float* sx, int32_t* part, void* stream) {
  if (M <= kGemvRows)
    return t5g_w8a8_gemv(x, x_is_bf16, M, K, w, sw, N, out, out_is_bf16, x8, sx, 0, stream);
  const int e = t5g_quantize_rows(x, x_is_bf16, M, K, x8, sx, stream);
  if (e != 0) return e;
  return static_cast<int>(t5g::launch_tc<false>(x8, sx, w, sw, out, out_is_bf16, part, M, N,
                                                K, static_cast<cudaStream_t>(stream)));
}

extern "C" int t5g_row_absmax(const void* x, int x_is_bf16, int M, int K, float* amax,
                              void* stream) {
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    t5g::row_absmax_kernel<__nv_bfloat16>
        <<<M, t5g::kRowThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), K, amax);
  else
    t5g::row_absmax_kernel<float><<<M, t5g::kRowThreads, 0, s>>>(static_cast<const float*>(x), K,
                                                                  amax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int t5g_quantize_rows_amax(const void* x, int x_is_bf16, int M, int K,
                                      const float* amax, int8_t* x8, float* sx, void* stream) {
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    t5g::quantize_tiles_kernel<__nv_bfloat16><<<M, t5g::kRowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), K, 0, K, 1, amax, x8, sx);
  else
    t5g::quantize_tiles_kernel<float><<<M, t5g::kRowThreads, 0, s>>>(
        static_cast<const float*>(x), K, 0, K, 1, amax, x8, sx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int t5g_w8a8_int(const int8_t* x8, int M, int K, const int8_t* w, int N,
                            int32_t* out, int32_t* part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kGemvRows) {
    t5g::GemvIntArgs p{x8, w, out, M, N, K, 0, K, 1};
    return static_cast<int>(t5g::launch_gemv_int<false>(p, s));
  }
  return static_cast<int>(t5g::launch_tc<false>(x8, nullptr, w, nullptr, out, t5g::kOutInt32,
                                                part, M, N, K, s));
}

extern "C" int t5g_rescale_rows(const int32_t* acc, const float* sx, const float* sw, int M,
                                int N, void* out, int out_is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_is_bf16
          ? t5g::launch_rescale_tiles(acc, sx, sw, M, 1, N, static_cast<__nv_bfloat16*>(out), s)
          : t5g::launch_rescale_tiles(acc, sx, sw, M, 1, N, static_cast<float*>(out), s));
}
