// W8A16 matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/quant.py::_qmm_kernel
// (reached through _qmm_2d, which q_matmul takes for act_bits=16 weights):
//
//   out[m, n] = f32(sum_k bf16(x[m, k]) * w[n, k]) * s[n]
//
// x [M, K] is f32 or bf16 and is rounded to bf16 (round to nearest even, as
// jnp's astype; bf16 x passes unchanged). w [N, K] holds int8 levels,
// channel-major (ops/quant.py::QuantWeight), s [N] f32 per-channel scales.
// Each product of a bf16 value and a level (|q| <= 127) is exact in f32, so
// only the order of the f32 sums differs from the plain version; the scale
// multiplies the finished sum (__fmul_rn) and is never folded into the
// weights (that would round each product). The output is f32 or bf16
// (round to nearest even) and N may be odd (65,541 for the head's w2), so
// every output element is stored on its own.
//
// Bound. At decode sizes (M = 4: 26 x 6 layer products and the head's two
// a step) the product reads each weight byte once and does 2 M operations
// per byte, far below the bf16 tensor rate: the weight bytes over HBM
// bound it. At prefill sizes (M = 256-260) it does 2 M K N operations
// against K N weight bytes, still under the H100's ~295 operations a byte,
// so both bounds are close.
//
// One route at every M: bf16 tensor cores with swapped operands, built
// like w8a8_tc.cuh (whose TMA, mbarrier and descriptor helpers it uses):
//   * out^T = W x^T. 64 weight channels are wgmma's M (one consumer
//     warpgroup each, two a CTA: 128 channels), the activation rows its N:
//     one wgmma.m64nNIk16.f32.bf16.bf16 per 16 K, NI the narrowest width of
//     kTcWidths that holds the row tile (M = 1..8 -> 8; 260 -> 2 x 144).
//   * A (the weights) comes from registers. Each thread reads its fragment
//     of the int8 tile from shared memory (two levels a 16-bit load) and
//     converts it to bf16 in the register with integer ops and one packed
//     bf16 subtraction (levels_bf16x2): every level is exact in bf16, so no
//     bf16 copy of the weights is ever written and the weight stream stays
//     one byte a level.
//   * B is x in bf16, brought by TMA with the weights into a ring of 3..8
//     K tiles (128 levels; the x tile as two 64-wide boxes, each one
//     128-byte swizzle span) with mbarriers: one producer warp issues the
//     loads, the two consumer warpgroups run wgmma. TMA copies bytes and
//     does not convert, so an f32 x is first rounded to bf16 into the
//     caller's scratch (round_rows_kernel); TMA fills reads outside the
//     tensors with zeros, so ragged M, N and K add nothing.
//   * Small row tiles (NI <= 32) run two CTAs an SM (a ring of 96 KB each),
//     so that a split CTA's pipeline fill overlaps another's stream.
//   * Split K where the grid is under one wave of SMs (every decode product
//     but gate_up and the head's w2), and in two where it is resident at
//     once but uneven over the SMs (gate_up's 144 channel tiles on 132
//     SMs): the K tiles are dealt out to `splits` CTAs that store f32
//     partial sums [splits, M, N] in the caller's scratch; a second kernel,
//     launched as a programmatic dependent so that its launch overlaps the
//     first, adds them in split order (no atomics: the sum does not depend
//     on the run) and applies the scale and the output rounding once.
//   * The weights are read once, so their TMA map asks no L2 promotion.
// The plan (w16_plan: width, row tiles, channel tiles, K tiles, splits,
// CTAs per SM) is a function of the shape and the card, so a CUDA graph
// captures the launch; chip_smoke.py prints it beside each product's time
// (PERF.md, kernel 6).

#include "w8a8_tc.cuh"

namespace {

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

// Two int8 levels (K k and k + 1, the low and high byte of `two`) as a
// bf16x2 word, exactly: with u = q & 127 and the sign bit h, bf16 bits
// 0x4300 | u are 128 + u and 0x4300 | (h << 7) are 128 + 128 h, so their
// difference is u - 128 h = q, an integer in [-128, 127] that bf16 holds
// (the subtraction rounds nothing).
__device__ __forceinline__ uint32_t levels_bf16x2(uint32_t two) {
  const uint32_t spread = __byte_perm(two, 0u, 0x4140);   // q_k in bits 0-7, q_k+1 in 16-23
  const uint32_t a = (spread & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (spread & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// wgmma.m64nNIk16.f32.bf16.bf16, A from registers, B (K-major) from shared
// memory through a descriptor: d (64 x NI, f32) += a (64 x 16) * b (16 x NI).
// One specialization for each width of kTcWidths.
template <int NI>
struct WgmmaBf16;

template <>
struct WgmmaBf16<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<24> {
  static __device__ __forceinline__ void run(float (&d)[12], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<48> {
  static __device__ __forceinline__ void run(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<80> {
  static __device__ __forceinline__ void run(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<96> {
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<112> {
  static __device__ __forceinline__ void run(float (&d)[56], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<144> {
  static __device__ __forceinline__ void run(float (&d)[72], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
        "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Keeps the compiler from moving accumulator reads or writes across a wgmma
// fence or wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

struct W16Args {
  const float* s;    // [N]
  void* out;         // [M, N] f32 or bf16 (splits == 1)
  float* part;       // [splits, M, N] f32 partial sums (splits > 1)
  int M, N, ktiles, splits, rowtiles, ntiles, out_bf16;
};

template <int NI>
struct W16Tile {
  static constexpr int kABytes = t5g::kTcChannels * t5g::kTcK;   // int8 [128 ch][128 K]
  static constexpr int kBHalf = NI * 128;                         // bf16 [NI][64 K]: one swizzle span
  static constexpr int kBBytes = 2 * kBHalf;                      // multiple of 1024
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPerSm = NI <= 32 ? 2 : 1;                 // CTAs an SM
  static constexpr int kFit = (kPerSm == 2 ? 96 : 192) * 1024 / kStageBytes;
  static constexpr int kStages = kFit < 3 ? 3 : (kFit > 8 ? 8 : kFit);
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

template <int NI>
__global__ void __launch_bounds__(t5g::kTcThreads, W16Tile<NI>::kPerSm)
w8a16_tc_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                const W16Args p) {
  using T = W16Tile<NI>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sb = smem;                                   // S x kBBytes (1024-aligned)
  uint8_t* sa = smem + S * T::kBBytes;                  // S x kABytes
  uint64_t* full = reinterpret_cast<uint64_t*>(sa + S * T::kABytes);
  uint64_t* empty = full + S;

  int bid = blockIdx.x;
  const int rt = bid % p.rowtiles;
  bid /= p.rowtiles;
  const int nt = bid % p.ntiles;
  const int sp = bid / p.ntiles;
  const int n0 = nt * t5g::kTcChannels, m0 = rt * NI;
  const int kt0 = static_cast<int>(static_cast<int64_t>(sp) * p.ktiles / p.splits);
  const int kt1 = static_cast<int>(static_cast<int64_t>(sp + 1) * p.ktiles / p.splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      t5g::mbar_init(&full[s], 1);
      t5g::mbar_init(&empty[s], t5g::kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the merge kernel may launch now and wait (griddepcontrol.wait) for this
  // grid to complete: its launch overlaps this grid's work
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  if (warp == t5g::kTcConsumerWarps) {                  // producer
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % S;
        t5g::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        t5g::mbar_expect_tx(&full[s], T::kStageBytes);
        t5g::tma_load_2d(sa + s * T::kABytes, &tw, kt * t5g::kTcK, n0, &full[s]);
        // x's K tile in bytes (2 a level): two boxes of 64 levels
        t5g::tma_load_2d(sb + s * T::kBBytes, &tx, kt * 2 * t5g::kTcK, m0, &full[s]);
        t5g::tma_load_2d(sb + s * T::kBBytes + T::kBHalf, &tx, kt * 2 * t5g::kTcK + 128, m0,
                         &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes channels n0 + 64 wg .. + 63. The A
  // fragment of K step kk (16 levels, the 16-byte chunk kk of a 128-byte
  // swizzled row, stored at chunk kk ^ (row & 7)) holds rows r and r + 8,
  // K 2t, 2t + 1 and 2t + 8, 2t + 9 (the wgmma register layout of a 16-bit
  // A operand).
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * wi + g;                  // channel row in the tile; r & 7 == g
  float acc[NI / 2];
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) acc[i] = 0.f;

  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % S;
    t5g::mbar_wait(&full[s], (i / S) & 1);
    const uint8_t* a0 = sa + s * T::kABytes + r * 128 + 2 * t;
    const uint8_t* a1 = a0 + 8 * 128;
    uint32_t frag[t5g::kTcK / 16][4];
#pragma unroll
    for (int kk = 0; kk < t5g::kTcK / 16; ++kk) {
      const int c = (kk ^ g) << 4;
      frag[kk][0] = levels_bf16x2(*reinterpret_cast<const uint16_t*>(a0 + c));
      frag[kk][1] = levels_bf16x2(*reinterpret_cast<const uint16_t*>(a1 + c));
      frag[kk][2] = levels_bf16x2(*reinterpret_cast<const uint16_t*>(a0 + c + 8));
      frag[kk][3] = levels_bf16x2(*reinterpret_cast<const uint16_t*>(a1 + c + 8));
    }
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint8_t* b = sb + s * T::kBBytes;
#pragma unroll
    for (int kk = 0; kk < t5g::kTcK / 16; ++kk)
      WgmmaBf16<NI>::run(acc, frag[kk],
                         t5g::sw128_desc(b + (kk >> 2) * T::kBHalf + 32 * (kk & 3)));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) t5g::mbar_arrive(&empty[s]);
  }

  // accumulator layout: acc[i] is channel r + 8 ((i >> 1) & 1), row
  // 8 (i >> 2) + 2 t + (i & 1) of the tile
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) {
    const int n = n0 + r + 8 * ((i >> 1) & 1);
    const int m = m0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (m >= p.M || n >= p.N) continue;
    const int64_t o = static_cast<int64_t>(m) * p.N + n;
    if (p.splits > 1) {
      p.part[static_cast<int64_t>(sp) * p.M * p.N + o] = acc[i];
    } else {
      const float v = __fmul_rn(acc[i], p.s[n]);
      if (p.out_bf16)
        store_out(static_cast<__nv_bfloat16*>(p.out), o, v);
      else
        store_out(static_cast<float*>(p.out), o, v);
    }
  }
}

// Adds the split-K partial sums in split order, then the scale and the
// output rounding once. Launched as a programmatic dependent of the split
// kernel: it waits here until that grid has completed and its partials are
// visible.
__global__ void __launch_bounds__(256)
w8a16_merge_kernel(const W16Args p) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int64_t mn = static_cast<int64_t>(p.M) * p.N;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (o >= mn) return;
  float tot = p.part[o];
  for (int s = 1; s < p.splits; ++s) tot += p.part[s * mn + o];
  const float v = __fmul_rn(tot, p.s[o % p.N]);
  if (p.out_bf16)
    store_out(static_cast<__nv_bfloat16*>(p.out), o, v);
  else
    store_out(static_cast<float*>(p.out), o, v);
}

// x f32 [n8 x 8] -> bf16, round to nearest even: TMA's source for f32 x.
__global__ void __launch_bounds__(256)
round_rows_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb, int64_t n8) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i < n8) reinterpret_cast<uint4*>(xb)[i] = load8_bf16(x + 8 * i);
}

// One kernel instantiation: its entry, dynamic shared memory and the CTAs
// that fit on one SM.
template <int NI>
const t5g::TcKernel& w16_kernel() {
  static const t5g::TcKernel k = [] {
    t5g::TcKernel r{reinterpret_cast<const void*>(&w8a16_tc_kernel<NI>), W16Tile<NI>::kSmem, 0,
                    cudaSuccess};
    r.err = cudaFuncSetAttribute(w8a16_tc_kernel<NI>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, r.smem);
    if (r.err == cudaSuccess)
      r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.per_sm, w8a16_tc_kernel<NI>,
                                                            t5g::kTcThreads, r.smem);
    return r;
  }();
  return k;
}

const t5g::TcKernel& w16_kernel_for(int ni) {
  switch (ni) {
    case 8: return w16_kernel<8>();
    case 16: return w16_kernel<16>();
    case 24: return w16_kernel<24>();
    case 32: return w16_kernel<32>();
    case 48: return w16_kernel<48>();
    case 64: return w16_kernel<64>();
    case 80: return w16_kernel<80>();
    case 96: return w16_kernel<96>();
    case 112: return w16_kernel<112>();
    case 128: return w16_kernel<128>();
    default: return w16_kernel<144>();
  }
}

struct W16Plan {
  int ni, rowtiles, ntiles, ktiles, splits, per_sm;
};

// Row tiles of at most kTcMaxRows rows, each the narrowest width of
// kTcWidths that holds it; 128 weight channels and 128 K levels a tile.
// Where the channel and row tiles are fewer than the SMs, K is split into
// as many ranges as keep the grid to one wave of SMs; where they are
// resident at once (CTAs per SM times the SMs) but more than the SMs, some
// SMs would hold twice the work, and K is split in two. Each split keeps at
// least two K tiles; split s takes K tiles [s ktiles / splits, (s + 1)
// ktiles / splits). (Measured on an H100 over 1-36 splits at the main
// path's shapes: PERF.md, kernel 6.)
W16Plan w16_plan(int M, int N, int K) {
  W16Plan q;
  q.rowtiles = (M + t5g::kTcMaxRows - 1) / t5g::kTcMaxRows;
  const int mt = (M + q.rowtiles - 1) / q.rowtiles;
  q.ni = t5g::kTcMaxRows;
  for (int w : t5g::kTcWidths)
    if (w >= mt) {
      q.ni = w;
      break;
    }
  q.ntiles = (N + t5g::kTcChannels - 1) / t5g::kTcChannels;
  q.ktiles = (K + t5g::kTcK - 1) / t5g::kTcK;
  q.per_sm = w16_kernel_for(q.ni).per_sm;
  const int64_t sms = t5g::sm_count();
  const int64_t tiles = static_cast<int64_t>(q.ntiles) * q.rowtiles;
  const int64_t want = tiles < sms ? sms / tiles : (tiles < sms * q.per_sm ? 2 : 1);
  const int64_t most = q.ktiles / 2;
  q.splits = static_cast<int>(want < most ? want : most);
  if (q.splits < 1) q.splits = 1;
  return q;
}

// xb the bf16 copy of an f32 x, part the [splits, M, N] f32 partial sums
// (splits > 1), both the caller's scratch; `splits` > 0 replaces the plan's
// count (a measurement's sweep; 0 on every other call).
template <typename OutT>
cudaError_t launch_tc(const void* xv, int x_is_bf16, const int8_t* w, const float* s, void* out,
                      __nv_bfloat16* xb, float* part, int M, int N, int K, int splits,
                      cudaStream_t st) {
  W16Plan q = w16_plan(M, N, K);
  if (splits > q.ktiles) return cudaErrorInvalidValue;
  if (splits > 0) q.splits = splits;
  if ((q.splits > 1 && part == nullptr) || (!x_is_bf16 && xb == nullptr))
    return cudaErrorInvalidValue;
  const t5g::TcKernel& k = w16_kernel_for(q.ni);
  if (k.err != cudaSuccess) return k.err;
  const void* xt = xv;
  if (!x_is_bf16) {
    const int64_t n8 = static_cast<int64_t>(M) * K / 8;
    round_rows_kernel<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(xv), xb, n8);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    xt = xb;
  }
  CUtensorMap tw, tx;
  // the weights are read once: no L2 promotion of their 128-byte rows
  if (!t5g::make_map(&tw, w, N, K, t5g::kTcChannels, t5g::kTcK, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE) ||
      !t5g::make_map(&tx, xt, M, 2 * K, q.ni, 128, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  W16Args a{s, out, part, M, N, q.ktiles, q.splits, q.rowtiles, q.ntiles,
            static_cast<int>(sizeof(OutT) == 2)};
  void* args[] = {&tw, &tx, &a};
  cudaError_t e = cudaLaunchKernel(k.fn, dim3(q.rowtiles * q.ntiles * q.splits),
                                   dim3(t5g::kTcThreads), args, k.smem, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || q.splits == 1) return e;
  const int64_t mn = static_cast<int64_t>(M) * N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((mn + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w8a16_merge_kernel, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return e;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t code.
// x [M, K] f32 (x_is_bf16 = 0) or bf16, 16-byte aligned; w [N, K] int8,
// 16-byte aligned; s [N] f32; out [M, N] f32 (out_is_bf16 = 0) or bf16;
// K a multiple of 16.
//
// t5g_w8a16_plan:   the splits of the f32 [splits, M, N] scratch
//                   t5g_w8a16_matmul needs (0: none; -1: a K it refuses)
//                   and, in plan[6] when not null, the tiling (w16_plan:
//                   width, row tiles, channel tiles, K tiles, splits, CTAs
//                   per SM).
// t5g_w8a16_matmul: the product, with its scratch (xb: M x K bf16 for f32
//                   x; part: [splits, M, N] f32 for splits > 1); splits 0
//                   takes the plan's count, 1..K tiles that count instead
//                   (tools/torch_w8a16_splits.py).
extern "C" int t5g_w8a16_plan(int M, int N, int K, int* plan) {
  if (K <= 0 || K % 16) return -1;
  if (M < 1 || N < 1) {
    for (int i = 0; plan != nullptr && i < 6; ++i) plan[i] = 0;
    return 0;
  }
  const W16Plan q = w16_plan(M, N, K);
  if (plan != nullptr) {
    const int v[6] = {q.ni, q.rowtiles, q.ntiles, q.ktiles, q.splits, q.per_sm};
    for (int i = 0; i < 6; ++i) plan[i] = v[i];
  }
  return q.splits > 1 ? q.splits : 0;
}

extern "C" int t5g_w8a16_matmul(const void* x, int x_is_bf16, int M, int K, const int8_t* w,
                                const float* s, int N, void* out, int out_is_bf16, int splits,
                                __nv_bfloat16* xb, float* part, void* stream) {
  if (K % 16 || M < 0 || N < 0 || K <= 0 || splits < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_is_bf16
          ? launch_tc<__nv_bfloat16>(x, x_is_bf16, w, s, out, xb, part, M, N, K, splits, st)
          : launch_tc<float>(x, x_is_bf16, w, s, out, xb, part, M, N, K, splits, st));
}
