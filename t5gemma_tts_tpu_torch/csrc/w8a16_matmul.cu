// W8A16 matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/quant.py::_qmm_kernel
// (reached through _qmm_2d, which q_matmul takes for act_bits=16 weights):
//
//   out[m, n] = f32(sum_k bf16(x[m, k]) * w[n, k]) * s[n]
//
// x [M, K] is f32 or bf16 and is rounded to bf16 as it is read (round to
// nearest even, as jnp's astype; bf16 x passes unchanged). w [N, K] holds
// int8 levels, channel-major (ops/quant.py::QuantWeight), s [N] f32
// per-channel scales. Each product of a bf16 value and a level (|q| <= 127)
// is exact in f32, so only the order of the f32 sums differs from the plain
// version; the scale multiplies the finished sum and is never folded into
// the weights (that would round each product). The output is f32 or bf16
// (round to nearest even) and N may be odd (65,541 for the head's w2), so
// every output element is stored on its own.
//
// Bound. At decode sizes (M <= 16) the product reads each weight byte once
// and does 2 M operations per byte: far below the bf16 tensor rate, so the
// weight bytes over HBM bandwidth bound it. At prefill sizes (M = 256-260)
// it does 2 M K N operations against K N weight bytes: still below the
// H100's ~295 operations a byte at M = 260, but a tensor-core kernel comes
// close to both bounds only with a deep pipeline (later work).
//
// Two kernels:
// - M <= 16: a weight-streaming GEMV. A block of kGemvWarps warps owns
//   kGemvWarps output channels, one a warp. The block stages a K slab of
//   its rows of x in shared memory as bf16 (read from device memory once
//   per block instead of once per channel); each lane then streams its
//   channel's levels 16 at a time (one 16-byte load; neighbouring lanes on
//   neighbouring addresses), converts them to f32 in registers (exact) and
//   accumulates q * x in f32 for every row; a warp reduction finishes each
//   sum.
// - M > 16: a tiled tensor-core kernel. A block of four warps computes a
//   64 x 64 tile of out over K steps of 32: it stages x's 64 rows (rounded
//   to bf16) and w's 64 channels (int8 levels converted to bf16, exact) in
//   shared memory, and each warp multiplies its 32 x 32 part with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulation). Rows past M and channels
//   past N are staged as zeros and never stored.
// wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGemvWarps = 16;               // output channels per block
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kSlab = 1024;                  // K elements of x staged a pass
constexpr int kMaxRows = 16;                 // rows of the GEMV

constexpr int kBM = 64, kBN = 64, kBK = 32;  // tensor-core tile
constexpr int kLd = kBK + 8;                 // padded smem row (bf16): no bank conflicts
constexpr int kTileThreads = 128;

__device__ __forceinline__ void store_out(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive elements of x (16-byte aligned) as 8 bf16 in one uint4.
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 8 int8 levels (one 8-byte half of a 16-byte load) as 8 bf16, exactly.
__device__ __forceinline__ uint4 levels_bf16(int lo, int hi) {
  const int8_t* q0 = reinterpret_cast<const int8_t*>(&lo);
  const int8_t* q1 = reinterpret_cast<const int8_t*>(&hi);
  return make_uint4(pack_bf16(q0[0], q0[1]), pack_bf16(q0[2], q0[3]),
                    pack_bf16(q1[0], q1[1]), pack_bf16(q1[2], q1[3]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc += sum_j x[j] * q[j] over 8 bf16 x (one uint4) and 8 f32 levels.
__device__ __forceinline__ float dot8(uint4 xv, const float* q, float acc) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(x2[j]);
    acc = fmaf(f.x, q[2 * j], acc);
    acc = fmaf(f.y, q[2 * j + 1], acc);
  }
  return acc;
}

template <int MR, typename InT, typename OutT>
__global__ void __launch_bounds__(kGemvThreads)
w8a16_gemv_kernel(const InT* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s, OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 xs[MR * kSlab];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + warp;
  const bool active = n < N;   // every warp still helps stage x
  const int m0 = blockIdx.y * MR;
  const int rows = min(MR, M - m0);
  const int8_t* wrow = w + static_cast<int64_t>(active ? n : 0) * K;
  float acc[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSlab) {
    const int len = min(kSlab, K - k0);      // a multiple of 16
    const int per_row = len / 8;
    __syncthreads();                         // the previous slab is consumed
    for (int i = threadIdx.x; i < rows * per_row; i += kGemvThreads) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      *reinterpret_cast<uint4*>(xs + r * kSlab + c * 8) =
          load8_bf16(x + static_cast<int64_t>(m0 + r) * K + k0 + c * 8);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int c = lane; c < len / 16; c += 32) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(wrow + k0) + c);
      const int8_t* qb = reinterpret_cast<const int8_t*>(&raw);
      float q[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) q[j] = static_cast<float>(qb[j]);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < rows) {
          const uint4* xp = reinterpret_cast<const uint4*>(xs + r * kSlab + c * 16);
          acc[r] = dot8(xp[1], q + 8, dot8(xp[0], q, acc[r]));
        }
      }
    }
  }
  if (!active) return;
  const float sn = s[n];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r < rows) {
      const float tot = warp_sum(acc[r]);
      if (lane == 0) store_out(out, static_cast<int64_t>(m0 + r) * N + n, __fmul_rn(tot, sn));
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(kTileThreads)
w8a16_tile_kernel(const InT* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s, OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 as[kBM * kLd];   // x tile [m][k]
  __shared__ __align__(16) __nv_bfloat16 bs[kBN * kLd];   // w tile [n][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;        // mma fragment row group
  const int t = lane & 3;         // thread in group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // staging: thread -> smem row sr, 16 k from sk (x rows and w channels)
  const int sr = tid >> 1;
  const int sk = (tid & 1) * 16;
  const bool a_ok = m0 + sr < M;
  const bool b_ok = n0 + sr < N;
  const InT* xrow = x + static_cast<int64_t>(a_ok ? m0 + sr : 0) * K + sk;
  const int8_t* wrow = w + static_cast<int64_t>(b_ok ? n0 + sr : 0) * K + sk;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool k_ok = k0 + sk < K;          // K % 16 == 0: all 16 or none
    uint4 a0 = zero, a1 = zero, b0 = zero, b1 = zero;
    if (a_ok && k_ok) {
      a0 = load8_bf16(xrow + k0);
      a1 = load8_bf16(xrow + k0 + 8);
    }
    if (b_ok && k_ok) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(wrow + k0));
      b0 = levels_bf16(raw.x, raw.y);
      b1 = levels_bf16(raw.z, raw.w);
    }
    __syncthreads();                        // the previous tile is consumed
    uint4* ad = reinterpret_cast<uint4*>(as + sr * kLd + sk);
    uint4* bd = reinterpret_cast<uint4*>(bs + sr * kLd + sk);
    ad[0] = a0;
    ad[1] = a1;
    bd[0] = b0;
    bd[1] = b1;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = as + (wm + mi * 16 + g) * kLd + kk + 2 * t;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * kLd);
        af[mi][2] = lds32(p + 8);
        af[mi][3] = lds32(p + 8 * kLd + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p = bs + (wn + ni * 8 + g) * kLd + kk + 2 * t;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  // accumulator (mi, ni, j): row g (+8 for j >= 2), column 2 t + (j & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = m0 + wm + mi * 16 + g + (j >= 2 ? 8 : 0);
        const int c = n0 + wn + ni * 8 + 2 * t + (j & 1);
        if (r < M && c < N)
          store_out(out, static_cast<int64_t>(r) * N + c, __fmul_rn(acc[mi][ni][j], s[c]));
      }
    }
  }
}

template <int MR, typename InT, typename OutT>
cudaError_t launch_gemv(const InT* x, const int8_t* w, const float* s, OutT* out, int M, int N,
                        int K, cudaStream_t stream) {
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps, (M + MR - 1) / MR);
  w8a16_gemv_kernel<MR, InT, OutT><<<grid, kGemvThreads, 0, stream>>>(x, w, s, out, M, N, K);
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch(const void* xv, const int8_t* w, const float* s, void* ov, int M, int N, int K,
                   cudaStream_t stream) {
  const InT* x = static_cast<const InT*>(xv);
  OutT* out = static_cast<OutT*>(ov);
  if (M <= 1) return launch_gemv<1>(x, w, s, out, M, N, K, stream);
  if (M <= 2) return launch_gemv<2>(x, w, s, out, M, N, K, stream);
  if (M <= 4) return launch_gemv<4>(x, w, s, out, M, N, K, stream);
  if (M <= 8) return launch_gemv<8>(x, w, s, out, M, N, K, stream);
  if (M <= kMaxRows) return launch_gemv<kMaxRows>(x, w, s, out, M, N, K, stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a16_tile_kernel<InT, OutT><<<grid, kTileThreads, 0, stream>>>(x, w, s, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a cudaError_t code.
// x [M, K] f32 (x_is_bf16 = 0) or bf16, rows 16-byte aligned; w [N, K] int8,
// 16-byte aligned; s [N] f32; out [M, N] f32 (out_is_bf16 = 0) or bf16.
extern "C" int t5g_w8a16_matmul(const void* x, int x_is_bf16, int M, int K, const int8_t* w,
                                const float* s, int N, void* out, int out_is_bf16,
                                void* stream) {
  if (K % 16 || M < 0 || N < 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_is_bf16)
    e = out_is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, s, out, M, N, K, st)
                    : launch<__nv_bfloat16, float>(x, w, s, out, M, N, K, st);
  else
    e = out_is_bf16 ? launch<float, __nv_bfloat16>(x, w, s, out, M, N, K, st)
                    : launch<float, float>(x, w, s, out, M, N, K, st);
  return static_cast<int>(e);
}
