// W8A8 and W4A8 products on Hopper's int8 tensor cores (sm_90a), for the
// products of more than a few rows: the prefill's projections, cross K/V
// and the speculative verify pass's head. Included by w8a8_matmul.cu and
// w4a8_matmul.cu, and by w8a16_matmul.cu for its TMA, mbarrier, descriptor
// and planning helpers; the decode layer keeps the GEMV of w8a8.cuh.
//
// Counterpart of the TPU kernels t5gemma_tts_tpu/ops/quant.py::_w8a8_kernel
// and ::_w4a8_kernel, with the semantics of w8a8.cuh's header:
//
//   out[m, n] = (f32(sum_k x8[m, k] * w[n, k]) * sx[m]) * sw[n]
//
// with one rounding per multiply (__fmul_rn) on the exact int32 sum, so the
// result equals the plain PyTorch version's bits, f32 and bf16 alike.
//
// Bound. At M = 5..260 rows against 2304..65541 channels the product does
// 2 M operations per weight byte (4 M for int4): below about M = 300 the
// weight stream over HBM bounds it, not the 1,979 TOP/s of the int8 tensor
// cores. The GEMV of w8a8.cuh reaches that stream only for M <= 16: it
// multiplies on the CUDA cores (__dp4a) and re-reads the weights from L2
// for every group of 16 rows. Here the multiply goes to the tensor cores
// and every weight byte is read from HBM once per call.
//
// Design.
// * Swapped operands: out^T = W x8^T. 64 weight channels are wgmma's M (one
//   consumer warpgroup each, two a CTA: 128 channels), the activation rows
//   its N, so a 5-row or 65-row product does not fill a 64-row tile with
//   zeros: one wgmma.m64nNIk32.s32.s8.s8 per 32 K, NI the narrowest s8
//   width of the PTX ISA (8, 16, 24, 32, 48, ..., 144) that holds the row
//   tile. One wide instruction, not several 16-row ones: the tensor cores
//   then read each weight fragment once per K step.
// * Operand A (the weights) comes from registers: each thread loads its
//   fragment from shared memory once per K tile; B (the int8 activations)
//   comes from shared memory through a descriptor. int4 weights reach the
//   fragment with the unpack of w8a8.cuh (load_weights16): one 32-bit word
//   of packed nibbles gives an int8x4 word of 16 q for 4 consecutive K,
//   which is exactly one register of an 8-bit A fragment. No int8 copy of
//   the int4 weights is written; the int32 total, a multiple of 16, shifts
//   right by 4 exactly.
// * TMA into a ring of 3..8 K tiles (128 levels each, about 120 KB) with
//   mbarriers: one producer warp issues the loads, the two consumer
//   warpgroups run wgmma. Tiles are 128-byte swizzled (64-byte for packed
//   int4 rows), so the fragment loads are free of bank conflicts and the
//   activation tile is what the wgmma descriptor expects. TMA fills reads
//   outside the tensor with zeros: a ragged M, N or K tail adds nothing to
//   the sums.
// * Split K where the grid is less than one wave (cross K/V, the 2304- and
//   4096-wide prefill products): the K tiles are dealt out to `splits` CTAs
//   that store int32 partial sums; a second kernel adds them (exact, in any
//   order) and runs the f32 epilogue once. The caller provides that
//   scratch ([splits, M, N] int32).
//
// Tiles: rows tile by up to 144 (M = 260 -> 2 x 144, 256 -> 2 x 128, 65 ->
// 80, 5 -> 8); K splits fill one wave of the kernel's occupancy, at least
// two K tiles a split (tc_plan). The route by M (the GEMV for M <= 16 in
// W8A8, M = 1 in W4A8) is in the entry points; chip_smoke.py times both
// routes at every M the main path sends and at the ragged M around the
// boundary (PERF.md, kernels 3 and 4).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8a8.cuh"


namespace t5g {

constexpr int kTcChannels = 128;   // weight channels per CTA (2 warpgroups)
constexpr int kTcK = 128;          // K levels per pipeline stage
constexpr int kTcMaxRows = 144;    // activation rows per CTA at most
constexpr int kTcThreads = 288;    // 2 consumer warpgroups + 1 producer warp
constexpr int kTcConsumerWarps = 8;

struct TcArgs {
  const float* sx;   // [M]
  const float* sw;   // [N]
  void* out;         // [M, N] f32 or bf16 (splits == 1)
  int32_t* part;     // [splits, M, N] int32 partial sums (splits > 1)
  int M, N, ktiles, splits, rowtiles, ntiles, out_bf16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed; a
// wait of seconds (a lost transaction) fails the launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), base 1024-aligned
// (a K step inside the row advances the start address by its bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// wgmma.m64nNIk32.s32.s8.s8, A from registers:
// d (64 x NI, int32) += a (64 x 32 int8) * b (32 x NI int8, shared memory).
// One specialization for each NI the row tiles use (the s8 shapes of the
// PTX ISA up to 144).
template <int NI>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(int (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(int (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void run(int (&d)[12], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(int (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void run(int (&d)[24], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void run(int (&d)[40], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void run(int (&d)[48], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void run(int (&d)[56], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<144> {
  static __device__ __forceinline__ void run(int (&d)[72], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
        "{%72, %73, %74, %75}, %76, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Keeps the compiler from moving register reads or writes across a wgmma
// fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int NI, bool W4>
struct TcTile {
  static constexpr int kARow = W4 ? kTcK / 2 : kTcK;                 // bytes a channel
  static constexpr int kABytes = kTcChannels * kARow;
  static constexpr int kBBytes = NI * kTcK;                           // multiple of 1024
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kFit = (120 * 1024) / kStageBytes;   // stages: 3..8
  static constexpr int kStages = kFit < 3 ? 3 : (kFit > 8 ? 8 : kFit);
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// The thread's A fragment of one K tile: frag[kk] holds rows r and r + 8
// (r = 16 warp + lane / 4 of the warpgroup's 64 channels), K 4t..4t+3 and
// 16+4t..16+4t+3 of K step kk (t = lane % 4), the wgmma register layout of
// an 8-bit A operand.
template <bool W4>
__device__ __forceinline__ void load_a(const uint8_t* tile, int r, int t,
                                       uint32_t (&frag)[kTcK / 32][4]) {
  const int g = r & 7;
#pragma unroll
  for (int kk = 0; kk < kTcK / 32; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {          // rows r, r + 8
      const int row = r + 8 * h;
      if constexpr (W4) {
        // 64-byte rows, 64-byte swizzle: 16-byte chunk c at c ^ ((row >> 1) & 3).
        // Chunk kk holds K step kk's 32 levels as 4 words of 8 levels.
        const uint8_t* base = tile + row * 64 + ((kk ^ ((g >> 1) & 3)) << 4) + 4 * (t >> 1);
        const uint32_t p0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t p1 = *reinterpret_cast<const uint32_t*>(base + 8);
        frag[kk][h] = (t & 1) ? (p0 & 0xF0F0F0F0u) : ((p0 << 4) & 0xF0F0F0F0u);
        frag[kk][2 + h] = (t & 1) ? (p1 & 0xF0F0F0F0u) : ((p1 << 4) & 0xF0F0F0F0u);
      } else {
        // 128-byte rows, 128-byte swizzle: 16-byte chunk c at c ^ (row & 7).
        const uint8_t* rowp = tile + row * 128 + 4 * t;
        frag[kk][h] = *reinterpret_cast<const uint32_t*>(rowp + (((2 * kk) ^ g) << 4));
        frag[kk][2 + h] = *reinterpret_cast<const uint32_t*>(rowp + (((2 * kk + 1) ^ g) << 4));
      }
    }
  }
}

template <int NI, bool W4>
__global__ void __launch_bounds__(kTcThreads, 1)
w8a8_tc_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
               const TcArgs p) {
  using T = TcTile<NI, W4>;
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
  const int n0 = nt * kTcChannels, m0 = rt * NI;
  const int kt0 = static_cast<int>(static_cast<int64_t>(sp) * p.ktiles / p.splits);
  const int kt1 = static_cast<int>(static_cast<int64_t>(sp + 1) * p.ktiles / p.splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kTcConsumerWarps) {                       // producer
    if (lane == 0) {
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % S;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::kStageBytes);
        tma_load_2d(sa + s * T::kABytes, &tw, kt * T::kARow, n0, &full[s]);
        tma_load_2d(sb + s * T::kBBytes, &tx, kt * kTcK, m0, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes channels n0 + 64 wg .. + 63
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * wi + g;                  // channel row in the tile
  int acc[NI / 2];
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) acc[i] = 0;

  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    uint32_t frag[kTcK / 32][4];
    load_a<W4>(sa + s * T::kABytes, r, t, frag);
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint8_t* b = sb + s * T::kBBytes;
#pragma unroll
    for (int kk = 0; kk < kTcK / 32; ++kk) Wgmma<NI>::run(acc, frag[kk], sw128_desc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
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
      const int tot = W4 ? (acc[i] >> 4) : acc[i];   // a sum of 16 q x8: exact
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(tot), p.sx[m]), p.sw[n]);
      if (p.out_bf16)
        store_out(static_cast<__nv_bfloat16*>(p.out), o, v);
      else
        store_out(static_cast<float*>(p.out), o, v);
    }
  }
}

// Adds the split-K partial sums (exact int32) and runs the epilogue once.
template <bool W4>
__global__ void __launch_bounds__(256)
w8a8_tc_merge_kernel(const TcArgs p) {
  const int64_t mn = static_cast<int64_t>(p.M) * p.N;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (o >= mn) return;
  int tot = 0;
  for (int s = 0; s < p.splits; ++s) tot += p.part[s * mn + o];
  if constexpr (W4) tot >>= 4;
  const int m = static_cast<int>(o / p.N), n = static_cast<int>(o % p.N);
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(tot), p.sx[m]), p.sw[n]);
  if (p.out_bf16)
    store_out(static_cast<__nv_bfloat16*>(p.out), o, v);
  else
    store_out(static_cast<float*>(p.out), o, v);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// One kernel instantiation: its entry, dynamic shared memory and the CTAs
// that fit on one SM.
struct TcKernel {
  const void* fn;
  int smem, per_sm;
  cudaError_t err;
};

template <int NI, bool W4>
static inline const TcKernel& tc_kernel() {
  static const TcKernel k = [] {
    TcKernel r{reinterpret_cast<const void*>(&w8a8_tc_kernel<NI, W4>), TcTile<NI, W4>::kSmem, 0,
               cudaSuccess};
    r.err = cudaFuncSetAttribute(w8a8_tc_kernel<NI, W4>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, r.smem);
    if (r.err == cudaSuccess)
      r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.per_sm, w8a8_tc_kernel<NI, W4>,
                                                            kTcThreads, r.smem);
    return r;
  }();
  return k;
}

// The s8 wgmma widths, in order: a row tile takes the first that holds it.
constexpr int kTcWidths[] = {8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 144};

template <bool W4>
static inline const TcKernel& tc_kernel_for(int ni) {
  switch (ni) {
    case 8: return tc_kernel<8, W4>();
    case 16: return tc_kernel<16, W4>();
    case 24: return tc_kernel<24, W4>();
    case 32: return tc_kernel<32, W4>();
    case 48: return tc_kernel<48, W4>();
    case 64: return tc_kernel<64, W4>();
    case 80: return tc_kernel<80, W4>();
    case 96: return tc_kernel<96, W4>();
    case 112: return tc_kernel<112, W4>();
    case 128: return tc_kernel<128, W4>();
    default: return tc_kernel<144, W4>();
  }
}

static inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

struct TcPlan {
  int ni, rowtiles, ntiles, ktiles, splits, per_sm;
};

// Row tiles of at most kTcMaxRows rows, each the narrowest wgmma width that
// holds it. Where the grid fills less than one wave (the kernel's CTAs per
// SM times the SMs), K is split into as many ranges as keep it to one wave,
// each at least two K tiles.
template <bool W4>
static inline TcPlan tc_plan(int M, int N, int K) {
  TcPlan q;
  q.rowtiles = (M + kTcMaxRows - 1) / kTcMaxRows;
  const int mt = (M + q.rowtiles - 1) / q.rowtiles;
  q.ni = kTcMaxRows;
  for (int w : kTcWidths)
    if (w >= mt) {
      q.ni = w;
      break;
    }
  q.ntiles = (N + kTcChannels - 1) / kTcChannels;
  q.ktiles = (K + kTcK - 1) / kTcK;
  q.per_sm = tc_kernel_for<W4>(q.ni).per_sm;
  const int64_t slots = static_cast<int64_t>(sm_count()) * (q.per_sm > 0 ? q.per_sm : 1);
  const int64_t base = static_cast<int64_t>(q.ntiles) * q.rowtiles;
  const int64_t fit = slots / base, most = q.ktiles / 2;
  q.splits = static_cast<int>(fit < most ? fit : most);
  if (q.splits < 1) q.splits = 1;
  return q;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (so the
// library needs no -lcuda).
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D byte tensor [rows, cols] (row stride cols bytes) read in boxes of
// [box_rows, box_cols]; reads outside it are zeros.
static inline bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                            int box_cols, CUtensorMapSwizzle swizzle,
                            CUtensorMapL2promotion promotion = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// True when the tensor-core route takes the shape: K a multiple of 16 (of
// 32 for packed int4 rows, whose row stride TMA needs a multiple of 16
// bytes), and the int4 sums of 16 q x8 exact (K <= 65536).
static inline bool tc_supports(int K, bool w4) {
  return K > 0 && K % (w4 ? 32 : 16) == 0 && (!w4 || K <= 65536);
}

// The plan of a product for its caller: {NI, row tiles, channel tiles, K
// tiles, splits, CTAs per SM}; returns the int32 [splits, M, N] scratch
// launch_tc needs (splits, 0 for none), or -1 for a K the route refuses.
template <bool W4>
static inline int tc_describe(int M, int N, int K, int* plan) {
  if (!tc_supports(K, W4)) return -1;
  const TcPlan q = tc_plan<W4>(M, N, K);
  if (plan != nullptr) {
    const int v[6] = {q.ni, q.rowtiles, q.ntiles, q.ktiles, q.splits, q.per_sm};
    for (int i = 0; i < 6; ++i) plan[i] = v[i];
  }
  return q.splits > 1 ? q.splits : 0;
}

// out [M, N] = (f32(x8 @ w^T) * sx) * sw on the tensor cores; x8 [M, K]
// int8 and w [N, K] int8 (or [N, K/2] packed int4) 16-byte aligned, part
// the [splits, M, N] int32 scratch of tc_plan when splits > 1.
template <bool W4>
static inline cudaError_t launch_tc(const int8_t* x8, const float* sx, const int8_t* w,
                                   const float* sw, void* out, int out_bf16, int32_t* part,
                                   int M, int N, int K, cudaStream_t s) {
  if (!tc_supports(K, W4)) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const TcPlan q = tc_plan<W4>(M, N, K);
  const TcKernel& k = tc_kernel_for<W4>(q.ni);
  if (k.err != cudaSuccess) return k.err;
  if (q.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  if (!make_map(&tw, w, N, W4 ? K / 2 : K, kTcChannels, W4 ? kTcK / 2 : kTcK,
                W4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tx, x8, M, K, q.ni, kTcK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  TcArgs a{sx, sw, out, part, M, N, q.ktiles, q.splits, q.rowtiles, q.ntiles, out_bf16};
  void* args[] = {&tw, &tx, &a};
  cudaError_t e = cudaLaunchKernel(k.fn, dim3(q.rowtiles * q.ntiles * q.splits),
                                   dim3(kTcThreads), args, k.smem, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || q.splits == 1) return e;
  const int64_t mn = static_cast<int64_t>(M) * N;
  w8a8_tc_merge_kernel<W4><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace t5g
