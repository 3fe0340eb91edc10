// W8A8 and W4A8 device code shared by w8a8_matmul.cu, w4a8_matmul.cu and
// decode_layer.cu (sm_90a).
//
// Counterpart of the TPU kernels t5gemma_tts_tpu/ops/quant.py::_w8a8_kernel
// and ::_w4a8_kernel and of the activation quantization
// ops/quant.py::_quantize_act:
//
//   sx[m]  = max(absmax_k |x[m, k]|, 1e-8) / 127
//   x8     = clip(rint(x / sx), -127, 127)          (rint: half to even)
//   out[m, n] = (f32(sum_k x8[m, k] * w[n, k]) * sx[m]) * sw[n]
//
// where w holds int8 levels (W8A8) or int4 levels in -7..7 (W4A8). The
// integer sums are exact; the rescale multiplies are rounded one by one
// (__fmul_rn, no fused multiply-add), so the kernels give the plain
// PyTorch versions' bits. Weights are stored channel-major: int8 [N, K],
// int4 packed [N, K/2] (ops/quant.py::Int4Weight).
//
// The K-tiled form (ktile < K) computes, in tile order,
//   acc = sum_j f32(sum_{k in tile j} x8[m, k] * w[n, k]) * sx[m, j]
//   out[m, n] = acc * sw[n]
// which is the megakernel's down product with per-tile activation scales
// (ops/megakernel.py:894-906); with one tile it is the formula above.
//
// int4 unpacking. The TPU kernels never unpack nibbles: Mosaic legalizes
// no int8 shift, so they take two int8 dots per tile and recover the lo/hi
// halves with an AND mask and a -8 * sum(x8) correction (quant.py:549-579).
// Hopper has shifts, so this unpacks in registers, and in the cheapest way
// that stays exact: a 32-bit word of packed weights holds 8 levels of 8
// consecutive K (low nibbles K 0..3, high nibbles K 4..7, one byte each);
// (word << 4) & 0xF0F0F0F0 and word & 0xF0F0F0F0 are two int8x4 words whose
// bytes are 16 q for K 0..3 and K 4..7 -- lined up with two consecutive
// int8x4 activation words, with no sign extension, no x8 permutation and
// no correction term. __dp4a then sums 16 q x8 exactly, and the int32 sum,
// a multiple of 16, shifts right by 4 exactly (|sum| <= 16 * 7 * 127 K <
// 2^31 for K <= 65536, checked by the wrapper). Signed nibbles were chosen
// over offset-8 ones for that reason: offset-8 levels need sum(x8) per row
// and K tile beside every dot.
//
// Bound: at decode batch sizes the product reads each weight byte once and
// does 2 operations per level and row, far below the int8 tensor rate, so
// it is bound by the weight bytes over HBM bandwidth (int4 halves them).
// The GEMV below gives one warp to one output channel; its 32 lanes stream
// the channel's weights 16 levels at a time (a 16-byte load of int8
// levels, an 8-byte load of int4 ones; neighbouring lanes on neighbouring
// addresses) and multiply them with __dp4a against up to kMaxRows
// activation rows at once, so each weight byte is read from device memory
// once per group of kMaxRows rows. Larger M (prefill) runs the same kernel
// over row groups (blockIdx.y), re-reading the weights from L2; the
// standalone products take it only at small M, and the tensor-core product
// of w8a8_tc.cuh (wgmma s8, TMA) above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t5g {

constexpr int kGemvWarps = 8;    // output channels per block
constexpr int kMaxRows = 16;     // activation rows per block
constexpr int kRowThreads = 256; // threads of the per-row kernels

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_out(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t quant_level(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

__device__ __forceinline__ float act_scale(float amax) {
  return fmaxf(amax, 1e-8f) / 127.0f;
}

// Block-wide max / sum over kRowThreads threads (result in every thread).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kRowThreads / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  for (int w = 0; w < kRowThreads / 32; ++w) v += red[w];
  return v;
}

// One block per row: x [M, K] (f32 or bf16, row stride x_stride) ->
// x8 [M, K] int8, sx [M] f32.
template <typename InT>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows_kernel(const InT* x, int64_t x_stride, int K, int8_t* x8, float* sx) {
  __shared__ float red[kRowThreads / 32];
  const int64_t row = blockIdx.x;
  const InT* xr = x + row * x_stride;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kRowThreads) amax = fmaxf(amax, fabsf(load_f32(xr, k)));
  const float s = act_scale(block_max(amax, red));
  for (int k = threadIdx.x; k < K; k += kRowThreads) x8[row * K + k] = quant_level(load_f32(xr, k), s);
  if (threadIdx.x == 0) sx[row] = s;
}

struct GemvArgs {
  const int8_t* x8;   // [M, K], rows 16-byte aligned
  const float* sx;    // [M, K / ktile]
  const int8_t* w;    // [N, K] int8 levels, or [N, K / 2] packed int4
  const float* sw;    // [N]
  void* out;          // [M, N] (row stride N), f32 or bf16
  int M, N, K, ktile;
};

// The 16 weights of chunk c (levels 16 c .. 16 c + 15) of one channel, as
// four int8x4 words lined up with the chunk's four activation words; int4
// levels come out as 16 q (see the header).
template <bool W4>
__device__ __forceinline__ void load_weights16(const int8_t* wrow, int c, int (&w)[4]) {
  if constexpr (W4) {
    const uint2 p = __ldg(reinterpret_cast<const uint2*>(wrow) + c);
    w[0] = static_cast<int>((p.x << 4) & 0xF0F0F0F0u);
    w[1] = static_cast<int>(p.x & 0xF0F0F0F0u);
    w[2] = static_cast<int>((p.y << 4) & 0xF0F0F0F0u);
    w[3] = static_cast<int>(p.y & 0xF0F0F0F0u);
  } else {
    const int4 v = __ldg(reinterpret_cast<const int4*>(wrow) + c);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

template <int MR, typename OutT, bool W4>
__global__ void __launch_bounds__(kGemvWarps * 32)
w8a8_gemv_kernel(const GemvArgs p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + warp;
  if (n >= p.N) return;
  const int m0 = blockIdx.y * MR;
  const int rows = min(MR, p.M - m0);
  const int nt = p.K / p.ktile;
  const int chunks = p.ktile / 16;          // 16-level chunks per tile
  const int8_t* wrow = p.w + static_cast<int64_t>(n) * (W4 ? p.K / 2 : p.K);
  float accf[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) accf[r] = 0.f;
  for (int j = 0; j < nt; ++j) {
    int acc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r] = 0;
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      const int cc = j * chunks + c;
      int wv[4];
      load_weights16<W4>(wrow, cc, wv);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < rows) {
          const int4 xv = __ldg(reinterpret_cast<const int4*>(
              p.x8 + static_cast<int64_t>(m0 + r) * p.K) + cc);
          acc[r] = __dp4a(xv.x, wv[0], acc[r]);
          acc[r] = __dp4a(xv.y, wv[1], acc[r]);
          acc[r] = __dp4a(xv.z, wv[2], acc[r]);
          acc[r] = __dp4a(xv.w, wv[3], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r < rows) {
        int tot = __reduce_add_sync(0xffffffffu, acc[r]);
        if constexpr (W4) tot >>= 4;          // a sum of 16 q x8: exact
        const float sc = p.sx[static_cast<int64_t>(m0 + r) * nt + j];
        accf[r] = __fadd_rn(accf[r], __fmul_rn(__int2float_rn(tot), sc));
      }
    }
  }
  if (lane == 0) {
    const float swn = p.sw[n];
    OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
    for (int r = 0; r < MR; ++r)
      if (r < rows) store_out(out, static_cast<int64_t>(m0 + r) * p.N + n, __fmul_rn(accf[r], swn));
  }
}

template <int MR, typename OutT, bool W4>
static inline cudaError_t launch_gemv_rows(const GemvArgs& p, cudaStream_t s) {
  const dim3 grid((p.N + kGemvWarps - 1) / kGemvWarps, (p.M + MR - 1) / MR);
  w8a8_gemv_kernel<MR, OutT, W4><<<grid, kGemvWarps * 32, 0, s>>>(p);
  return cudaGetLastError();
}

// Picks the row-group size from M (the smallest power of two >= M, at most
// kMaxRows). W4: int4 weights.
template <typename OutT, bool W4 = false>
static inline cudaError_t launch_gemv(const GemvArgs& p, cudaStream_t s) {
  if (p.K % 16 || p.ktile % 16 || p.ktile <= 0 || p.K % p.ktile) return cudaErrorInvalidValue;
  if (W4 && p.K > 65536) return cudaErrorInvalidValue;
  if (p.M == 0 || p.N == 0) return cudaSuccess;
  if (p.M <= 1) return launch_gemv_rows<1, OutT, W4>(p, s);
  if (p.M <= 2) return launch_gemv_rows<2, OutT, W4>(p, s);
  if (p.M <= 4) return launch_gemv_rows<4, OutT, W4>(p, s);
  if (p.M <= 8) return launch_gemv_rows<8, OutT, W4>(p, s);
  return launch_gemv_rows<kMaxRows, OutT, W4>(p, s);
}

template <typename InT>
static inline cudaError_t launch_quantize_rows(const InT* x, int64_t x_stride, int M, int K,
                                               int8_t* x8, float* sx, cudaStream_t s) {
  if (M == 0) return cudaSuccess;
  quantize_rows_kernel<InT><<<M, kRowThreads, 0, s>>>(x, x_stride, K, x8, sx);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row-split products (tensor parallelism). A rank holds K columns
// [k0, k0 + K) of a product whose activations the one-process path
// quantizes per row (or per `tile`-wide K tile) over the whole K. So the
// rank's quantization takes the group's absmax (an all-reduce MAX between
// calls), its product leaves exact int32 sums per whole-K tile (summed over
// the group as int32 between calls) and the rescale runs once on the sums,
// in tile order: the same levels, integer sums and f32 roundings as the
// one-process kernels.
// ---------------------------------------------------------------------------

// One block per row: amax[m] = max_k |x[m, k]|.
template <typename InT>
__global__ void __launch_bounds__(kRowThreads)
row_absmax_kernel(const InT* x, int K, float* amax) {
  __shared__ float red[kRowThreads / 32];
  const int64_t row = blockIdx.x;
  const InT* xr = x + row * K;
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += kRowThreads) m = fmaxf(m, fabsf(load_f32(xr, k)));
  m = block_max(m, red);
  if (threadIdx.x == 0) amax[row] = m;
}

// One block per row of x [M, K] (local columns k0 .. k0 + K of a product
// whose activation scales are per `tile`-wide tile of the whole K, NT
// tiles): the level of x[m, k] at its tile's scale act_scale(amax[m, j]),
// and sx[m, j] for every tile.
template <typename InT>
__global__ void __launch_bounds__(kRowThreads)
quantize_tiles_kernel(const InT* x, int K, int k0, int tile, int NT, const float* amax,
                      int8_t* x8, float* sx) {
  const int64_t row = blockIdx.x;
  const InT* xr = x + row * K;
  const float* am = amax + row * NT;
  for (int k = threadIdx.x; k < K; k += kRowThreads)
    x8[row * K + k] = quant_level(load_f32(xr, k), act_scale(am[(k0 + k) / tile]));
  for (int j = threadIdx.x; j < NT; j += kRowThreads) sx[row * NT + j] = act_scale(am[j]);
}

struct GemvIntArgs {
  const int8_t* x8;   // [M, K] local columns, rows 16-byte aligned
  const int8_t* w;    // [N, K] int8 levels, or [N, K / 2] packed int4
  int32_t* out;       // [M, NT, N]: each touched tile's exact int32 sum
  int M, N, K, k0, tile, NT;
};

// w8a8_gemv_kernel's weight stream with integer results: per whole-K tile
// j that the local columns touch, sum_{k in tile j} x8[m, k] * w[n, k]
// over the local part of the tile (int4: the sum of 16 q x8, shifted right
// by 4, exact). Tiles the local columns do not touch are left as they are.
template <int MR, bool W4>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_int_kernel(const GemvIntArgs p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + warp;
  if (n >= p.N) return;
  const int m0 = blockIdx.y * MR;
  const int rows = min(MR, p.M - m0);
  const int8_t* wrow = p.w + static_cast<int64_t>(n) * (W4 ? p.K / 2 : p.K);
  const int j0 = p.k0 / p.tile, j1 = (p.k0 + p.K - 1) / p.tile;
  for (int j = j0; j <= j1; ++j) {
    const int lo = max(j * p.tile - p.k0, 0) / 16;
    const int hi = min((j + 1) * p.tile - p.k0, p.K) / 16;
    int acc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r] = 0;
#pragma unroll 4
    for (int c = lo + lane; c < hi; c += 32) {
      int wv[4];
      load_weights16<W4>(wrow, c, wv);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < rows) {
          const int4 xv = __ldg(reinterpret_cast<const int4*>(
              p.x8 + static_cast<int64_t>(m0 + r) * p.K) + c);
          acc[r] = __dp4a(xv.x, wv[0], acc[r]);
          acc[r] = __dp4a(xv.y, wv[1], acc[r]);
          acc[r] = __dp4a(xv.z, wv[2], acc[r]);
          acc[r] = __dp4a(xv.w, wv[3], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r < rows) {
        int tot = __reduce_add_sync(0xffffffffu, acc[r]);
        if constexpr (W4) tot >>= 4;
        if (lane == 0) p.out[(static_cast<int64_t>(m0 + r) * p.NT + j) * p.N + n] = tot;
      }
    }
  }
}

template <int MR, bool W4>
static inline cudaError_t launch_gemv_int_rows(const GemvIntArgs& p, cudaStream_t s) {
  const dim3 grid((p.N + kGemvWarps - 1) / kGemvWarps, (p.M + MR - 1) / MR);
  gemv_int_kernel<MR, W4><<<grid, kGemvWarps * 32, 0, s>>>(p);
  return cudaGetLastError();
}

template <bool W4>
static inline cudaError_t launch_gemv_int(const GemvIntArgs& p, cudaStream_t s) {
  if (p.K % 16 || p.k0 % 16 || p.tile % 16 || p.tile <= 0 || p.NT <= 0 ||
      (p.k0 + p.K + p.tile - 1) / p.tile > p.NT)
    return cudaErrorInvalidValue;
  if (W4 && p.tile > 65536) return cudaErrorInvalidValue;
  if (p.M == 0 || p.N == 0 || p.K == 0) return cudaSuccess;
  if (p.M <= 1) return launch_gemv_int_rows<1, W4>(p, s);
  if (p.M <= 2) return launch_gemv_int_rows<2, W4>(p, s);
  if (p.M <= 4) return launch_gemv_int_rows<4, W4>(p, s);
  if (p.M <= 8) return launch_gemv_int_rows<8, W4>(p, s);
  return launch_gemv_int_rows<kMaxRows, W4>(p, s);
}

// One thread per (m, n): out[m, n] = (sum_j f32(acc[m, j, n]) * sx[m, j]) * sw[n]
// in tile order from 0, w8a8_gemv_kernel's f32 arithmetic on the group's
// integer sums (NT = 1: (f32(acc) * sx) * sw).
template <typename OutT>
__global__ void __launch_bounds__(256)
rescale_tiles_kernel(const int32_t* acc, const float* sx, const float* sw, int M, int NT, int N,
                     OutT* out) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (o >= static_cast<int64_t>(M) * N) return;
  const int64_t m = o / N;
  const int n = static_cast<int>(o - m * N);
  float a = 0.f;
  for (int j = 0; j < NT; ++j)
    a = __fadd_rn(a, __fmul_rn(__int2float_rn(acc[(m * NT + j) * N + n]), sx[m * NT + j]));
  store_out(out, o, __fmul_rn(a, sw[n]));
}

template <typename OutT>
static inline cudaError_t launch_rescale_tiles(const int32_t* acc, const float* sx,
                                               const float* sw, int M, int NT, int N, OutT* out,
                                               cudaStream_t s) {
  const int64_t mn = static_cast<int64_t>(M) * N;
  if (mn == 0) return cudaSuccess;
  rescale_tiles_kernel<OutT><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      acc, sx, sw, M, NT, N, out);
  return cudaGetLastError();
}

}  // namespace t5g
