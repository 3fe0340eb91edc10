// One int8- or int4-weight decoder layer (and the whole stack) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/megakernel.py::_kernel
// (reached through decode_layer and decode_stack) for W8A8 weights and for
// lanes4 int4 weights (its w4 variant), chain >= 1. One C call runs a fixed
// sequence of hand-written kernels per layer; t5g_decode_stack loops all
// layers, so a decode step is one host call. Per layer (h [B, D] stays f32
// across all layers):
//
//   1  x8, sx = quant(rms(h, n0))                 residual_norm_quant
//   2  qkv = (f32(x8 @ Wqkv) * sx) * s            w8a8_gemv (w8a8.cuh)
//   3  q = rope(q) * q_scale; k = rope(k); v       rope (f32; k, v -> knew/vnew)
//   4  self attention over prompt + generated      slab_logits, slab_split
//   5  + the in-flight token; a8, sa = quant(attn) merge_quant
//   6  o = (f32(a8 @ Wo) * sa) * s                 w8a8_gemv, exact int32 over K
//   7  h += rms(o, n1); x8, sx = quant(rms(h, n2)) residual_norm_quant
//   8  cq = W8A8 cross q; 9 rope(qcos, qsin) * q_scale
//   10-11 cross attention (encoder pages, length clamped to >= 1, no
//      current token): slab_logits, slab_split, then merge_quant (the
//      quantization too)
//   12 W8A8 cross o; 13 h += rms(., n3); x8 = quant(rms(h, n4))
//   14 gu = W8A8 gate_up (gate columns, then up columns)
//   15 per 512-wide F tile j (one tile of width F when F < 512):
//        t = gelu_tanh(g_j) * u_j; t8_j, st_j = quant(t_j)   geglu_quant
//   16 acc = sum_j f32(t8_j @ Wd_j) * st_j in tile order; d = acc * s_down
//   17 h += rms(d, n5)
//
// The six products (steps 2, 6, 8, 12, 14, 16) read int8 levels [N, K] or,
// with DecodeArgs::w4, packed int4 levels [N, K / 2] (the unpacking and
// its exactness are in w8a8.cuh); the integer sums are exact either way, so
// the int4 layer is the int8 layer's arithmetic on other levels. The TPU
// variant's doubled DMA chunk and its ones-matrix sum(x8) dot are Mosaic
// workarounds with no counterpart here.
//
// Attention follows the megakernel, not kernel 1: q is rounded to bf16 for
// the page dots, p (int8 pages: p * v_scale) is rounded to bf16 before the
// PV dot, int8 logits are multiplied by the k scale after the dot, the soft
// cap comes before the -0.7 * FLT_MAX mask, and the in-flight token joins
// last with the unrounded f32 q. Page addressing is the cache's identity
// slab layout: layer li, cache row c is slab row li * Bc + c.
//
// Chain (the speculative verify pass, DecodeArgs::chain = S > 1): every
// per-row kernel runs over B = Bc * S pseudo-rows, S chain positions of
// each of the Bc cache rows, position-major within a row. Pseudo-row b
// reads the slabs (and scale planes) of cache row b / S, with its own
// lengths, and its in-flight part is the causal chain (megakernel.py
// :596-641): it folds in the fresh k/v of chain positions j = 0 .. pos_in
// (pos_in = b - (b / S) * S) in order. For j < pos_in, k and v are
// store-rounded as the sequential engine reads them from the cache (bf16,
// and with int8 pages the per-token absmax / 127 quantize-dequantize,
// half to even, true division) and the dot takes the bf16-rounded q; for
// j = pos_in they are the raw f32 values and the dot takes the raw q;
// j > pos_in is masked, which leaves the statistics as they are (exp of
// the mask value is 0), so it is skipped.
//
// Bound: at decode batch sizes the layer is bound by its bytes: the int8
// weights (87.3 MB per layer at 2b-2b, half that in int4), read once per
// step, plus the valid K/V bytes. What the design does about each:
//
// - the products: w8a8.cuh's GEMV (a warp a channel, x8 through L1), the
//   heads' route too.
// - attention, split-KV: B x Hkv (cache row, kv head) pairs are 4-16 CTAs
//   on 132 SMs, so each pass takes one CTA per (split, kv head, cache
//   row). The host's plan (ops/megakernel.py::attention_plan) cuts the
//   slabs' capacity, never the lengths (no host sync; a CUDA graph captures
//   the launch), into chunks of a divisor of the page so that the grid
//   fills a wave. One CTA serves all S x G queries of its cache row's chain
//   and kv head, so each page element is read once per (cache row, kv
//   head): K by slab_logits, V by slab_split. slab_logits: a warp per
//   token, a lane per 8-element chunk of hd (one 16-byte load of bf16, 8 of
//   int8), reducing only the real queries; it writes the logits and each
//   chunk's maximum. slab_split rounds p relative to the running max of its
//   128-token block as the plain version sees it (the prefix max of the
//   chunk maxima), so p rounds to the plain version's bf16 values: a max of
//   the chunk's own would move p by a bf16 step, enough to flip greedy
//   tokens. P.V: a warp per token, each lane owning 8 output dims,
//   registers summed across warps in a fixed order through shared memory.
//   A chunk past the row's length writes the neutral partial (0, mask, 0).
//   merge_quant: one CTA per pseudo-row over all heads combines the
//   partials in split order (only those of splits that hold the row's
//   tokens: the rest are exactly neutral), folds in the in-flight chain,
//   normalizes with l > 0 ? l : 1 and quantizes the row for the o /
//   cross-o product.
//
// Rounding and the rescales use __fmul_rn / __fadd_rn (no fused
// multiply-add), so every elementwise step gives the plain PyTorch
// version's bits; only sums differ in order. A single persistent kernel per
// step is later work.

#include "w8a8.cuh"

#define T5G_CHECK(x)                          \
  do {                                        \
    const cudaError_t e_ = (x);               \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

namespace {

using namespace t5g;

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kBlock = 128;        // attention time block (= page size)
constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kGroup = 8;          // logits: queries per register group
constexpr int kPV = 4;             // P.V: queries per register group
constexpr int kBatch = 4;          // tokens a warp loads before it computes
constexpr int kMergeBatch = 8;     // splits a merge warp loads before it sums

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float cap(float x, float soft_cap) {
  return soft_cap > 0.f ? __fmul_rn(tanhf(x / soft_cap), soft_cap) : x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// rms(x, w) = (x * rsqrt(mean(x^2) + eps)) * (1 + w)
__device__ __forceinline__ float row_rsqrt(float ss, int D, float eps) {
  return rsqrtf(__fadd_rn(ss / static_cast<float>(D), eps));
}

// One block per row b: if y, h[b] += rms(y[b], w_post); then, if w_pre,
// x8[b], sx[b] = quant(rms(h[b], w_pre)). Every operand is loaded into
// shared memory first, in one pass whose loads are all in flight together
// (the row is latency-bound: one block, a few KB).
__global__ void __launch_bounds__(kRowThreads)
residual_norm_quant_kernel(float* h, const float* y, const float* w_post, const float* w_pre,
                           int D, float eps, int8_t* x8, float* sx) {
  extern __shared__ float row[];   // [D] h, then [D] each of y, w_post, w_pre
  __shared__ float red[kRowThreads / 32];
  const int64_t b = blockIdx.x;
  float* hb = h + b * D;
  float* ys = row + D;
  float* wpost = ys + D;
  float* wpre = wpost + D;
  for (int d = threadIdx.x; d < D; d += kRowThreads) {
    row[d] = hb[d];
    if (y != nullptr) {
      ys[d] = y[b * D + d];
      wpost[d] = w_post[d];
    }
    if (w_pre != nullptr) wpre[d] = w_pre[d];
  }
  if (y != nullptr) {
    float ss = 0.f;
    for (int d = threadIdx.x; d < D; d += kRowThreads) ss = __fadd_rn(ss, __fmul_rn(ys[d], ys[d]));
    const float r = row_rsqrt(block_sum(ss, red), D, eps);
    for (int d = threadIdx.x; d < D; d += kRowThreads) {
      const float n = __fmul_rn(__fmul_rn(ys[d], r), __fadd_rn(1.f, wpost[d]));
      row[d] = __fadd_rn(row[d], n);
      hb[d] = row[d];
    }
  }
  if (w_pre == nullptr) return;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kRowThreads) ss = __fadd_rn(ss, __fmul_rn(row[d], row[d]));
  const float r = row_rsqrt(block_sum(ss, red), D, eps);
  float amax = 0.f;
  for (int d = threadIdx.x; d < D; d += kRowThreads) {
    row[d] = __fmul_rn(__fmul_rn(row[d], r), __fadd_rn(1.f, wpre[d]));
    amax = fmaxf(amax, fabsf(row[d]));
  }
  const float s = act_scale(block_max(amax, red));
  for (int d = threadIdx.x; d < D; d += kRowThreads) x8[b * D + d] = quant_level(row[d], s);
  if (threadIdx.x == 0) sx[b] = s;
}

// Row b of src [B, src_stride], one element a thread over blocks
// (b, i / kRowThreads): the H query heads are roped and scaled into q_out
// [B, H, hd]; with k_out, the Hkv key heads that follow are roped into
// k_out [B, Hkv, hd] and the value heads copied into v_out.
// rope(x)[d] = x[d] * cos[d] + rot_half(x)[d] * sin[d].
__global__ void __launch_bounds__(kRowThreads)
rope_kernel(const float* src, int src_stride, const float* cos, const float* sin, int H, int Hkv,
            int hd, float q_scale, float* q_out, float* k_out, float* v_out) {
  const int64_t b = blockIdx.x;
  const int half = hd / 2;
  const float* s = src + b * src_stride;
  const float* c = cos + b * hd;
  const float* sn = sin + b * hd;
  const int nq = H * hd, nk = Hkv * hd;
  const int total = k_out != nullptr ? nq + 2 * nk : nq;
  const int i = blockIdx.y * kRowThreads + threadIdx.x;
  if (i < total) {
    if (i < nq + nk) {
      const int d = i % hd;
      const int base = i - d;
      const float rot = d < half ? -s[base + d + half] : s[base + d - half];
      const float v = __fadd_rn(__fmul_rn(s[i], c[d]), __fmul_rn(rot, sn[d]));
      if (i < nq) q_out[b * nq + i] = __fmul_rn(v, q_scale);
      else k_out[b * nk + (i - nq)] = v;
    } else {
      v_out[b * nk + (i - nq - nk)] = s[i];
    }
  }
}

// GeGLU of one (F tile j, row b): t = gelu_tanh(g) * u over the tile, then
// t8, st = quant(t) with the tile's own scale (x8 [B, F], sx [B, F/ftile]).
__global__ void __launch_bounds__(kRowThreads)
geglu_quant_kernel(const float* gu, int F, int ftile, int8_t* t8, float* st) {
  extern __shared__ float tile[];   // [ftile]
  __shared__ float red[kRowThreads / 32];
  const int j = blockIdx.x;
  const int64_t b = blockIdx.y;
  const float* g = gu + b * 2 * F + static_cast<int64_t>(j) * ftile;
  const float* u = g + F;
  float amax = 0.f;
  for (int e = threadIdx.x; e < ftile; e += kRowThreads) {
    tile[e] = __fmul_rn(gelu_tanh(g[e]), u[e]);
    amax = fmaxf(amax, fabsf(tile[e]));
  }
  const float s = act_scale(block_max(amax, red));
  int8_t* out = t8 + b * F + static_cast<int64_t>(j) * ftile;
  for (int e = threadIdx.x; e < ftile; e += kRowThreads) out[e] = quant_level(tile[e], s);
  if (threadIdx.x == 0) st[b * (F / ftile) + j] = s;
}

// A tensor-parallel rank's GeGLU: its F columns are k0 .. k0 + F of the
// whole intermediate, whose activation scales are per `tile`-wide tile (NT
// tiles). One block per (touched tile, row b): t = gelu_tanh(g) * u over
// the tile's local columns into t_out [B, F], and the local absmax of the
// tile into amax [B, NT] (geglu_quant_kernel's values, its quantization
// left for the group's absmax).
__global__ void __launch_bounds__(kRowThreads)
geglu_part_kernel(const float* gu, int F, int k0, int tile, int NT, float* t_out, float* amax) {
  __shared__ float red[kRowThreads / 32];
  const int j = k0 / tile + blockIdx.x;
  const int64_t b = blockIdx.y;
  const int lo = max(j * tile - k0, 0), hi = min((j + 1) * tile - k0, F);
  const float* g = gu + b * 2 * F;
  const float* u = g + F;
  float m = 0.f;
  for (int e = lo + threadIdx.x; e < hi; e += kRowThreads) {
    const float t = __fmul_rn(gelu_tanh(g[e]), u[e]);
    t_out[b * F + e] = t;
    m = fmaxf(m, fabsf(t));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) amax[b * NT + j] = m;
}

// ---------------------------------------------------------------------------
// attention: split-KV partials, then the merge with the in-flight chain
// ---------------------------------------------------------------------------

struct Seg {
  const void* k;        // [Hkv, L*Bc, T, hd] bf16 or int8
  const void* v;
  const float* ks;      // [Hkv, L*Bc, T] (int8 pages only)
  const float* vs;
  const int* len;       // [B]; nullptr = segment absent
  int T;                // slab capacity, a multiple of kBlock
};

struct AttnArgs {
  const float* q;       // [B, H, hd] roped and scaled, f32
  Seg seg[2];
  float* logits;        // [Bc, Hkv, S * G, splits * chunk] the first pass's logits
  float* part_cmax;     // [Bc, Hkv, splits, S * G] each chunk's largest valid logit
  float* part_acc;      // [Bc, Hkv, splits, S * G, hd] unnormalized partials
  float* part_m;        // [Bc, Hkv, splits, S * G]
  float* part_l;
  int LB, row0, H, Hkv, hd;
  int chain;            // S pseudo-rows per cache row
  float soft_cap;       // <= 0: no cap
  int clamp_a;          // segment A length clamped to >= 1
  int chunk, splits;    // the host's plan: splits * chunk = seg[0].T + seg[1].T
};

// 8 consecutive elements starting at element offset `off` (a multiple of 8).
template <bool QUANT>
__device__ __forceinline__ void load8(const void* base, int64_t off, float* out) {
  if constexpr (QUANT) {
    const int2 raw = *reinterpret_cast<const int2*>(reinterpret_cast<const int8_t*>(base) + off);
    const int8_t* r = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(r[j]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(base) + off);
    const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(r[j]);
  }
}

// What a CTA of either attention pass knows of its chunk: the segment, the
// chunk's offset in it, the lengths of the S chain positions of its cache
// row (segment A clamped to >= 1 for cross attention) and their largest.
struct Chunk {
  Seg sg;
  int off, maxlen;
  int64_t tok0;         // the slab element row of the chunk's first token
};

__device__ __forceinline__ Chunk locate(const AttnArgs& p, int split, int kvh, int c,
                                        int* len_s) {
  Chunk k;
  const int tok = split * p.chunk;
  const bool in_b = tok >= p.seg[0].T;
  k.sg = in_b ? p.seg[1] : p.seg[0];
  k.off = in_b ? tok - p.seg[0].T : tok;
  k.maxlen = 0;
  for (int j = 0; j < p.chain; ++j) {
    int len = k.sg.len[c * p.chain + j];
    if (!in_b && p.clamp_a) len = max(len, 1);
    k.maxlen = max(k.maxlen, len);
    if (threadIdx.x == j) len_s[j] = len;
  }
  k.tok0 = (static_cast<int64_t>(kvh) * p.LB + p.row0 + c) * k.sg.T + k.off;
  return k;
}

// Pass 1. One CTA per (split, kv head, cache row): the logits of the
// chunk's tokens for the S x G queries of the cache row's chain (query
// qi = j * G + g: chain position j, head kvh * G + g), bf16 q dotted with
// the K page, int8 logits scaled by the k scale after the dot, the soft
// cap; each query's largest valid logit of the chunk (the mask value if
// none) for pass 2's running maxima.
template <bool QUANT>
__global__ void __launch_bounds__(kAttnThreads)
slab_logits_kernel(const AttnArgs p) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int c = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int NQ = p.chain * G;
  const int hd = p.hd;
  const int chunk = p.chunk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool active = lane < hd / 8;

  extern __shared__ float smem[];
  float* qb_s = smem;                        // [NQ, hd] q rounded to bf16
  float* s_s = qb_s + NQ * hd;               // [NQ, chunk] logits
  int* len_s = reinterpret_cast<int*>(s_s + NQ * chunk);   // [S] lengths

  const Chunk k = locate(p, split, kvh, c, len_s);
  const int64_t cmax = (static_cast<int64_t>(c * p.Hkv + kvh) * p.splits + split) * NQ;
  const int n = min(chunk, k.maxlen - k.off);   // tokens that some query sees
  if (n <= 0) {
    for (int qi = tid; qi < NQ; qi += kAttnThreads) p.part_cmax[cmax + qi] = kMaskValue;
    return;
  }
  for (int i = tid; i < NQ * hd; i += kAttnThreads) {
    const int qi = i / hd;
    const int j = qi / G;
    const int64_t src = (static_cast<int64_t>(c * p.chain + j) * p.H + kvh * G + (qi - j * G)) *
                            hd + (i - qi * hd);
    qb_s[i] = bf16_round(p.q[src]);
  }
  __syncthreads();

  // a warp per token, kBatch tokens' K rows loaded first
  for (int t0 = warp; t0 < n; t0 += kAttnWarps * kBatch) {
    float kv[kBatch][8];
    float ksc[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kAttnWarps;
      ksc[u] = 1.f;
      if (t < n) {
        if (active) load8<QUANT>(k.sg.k, (k.tok0 + t) * hd + lane * 8, kv[u]);
        if constexpr (QUANT) ksc[u] = k.sg.ks[k.tok0 + t];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kAttnWarps;
      if (t >= n) break;
      for (int q0 = 0; q0 < NQ; q0 += kGroup) {
        float part_q[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          part_q[j] = 0.f;
          if (active && q0 + j < NQ) {
            const float* qg = qb_s + (q0 + j) * hd + lane * 8;
#pragma unroll
            for (int e = 0; e < 8; ++e) part_q[j] = __fadd_rn(part_q[j], __fmul_rn(qg[e], kv[u][e]));
          }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (q0 + j >= NQ) break;
          float x = warp_sum(part_q[j]);
          if constexpr (QUANT) x = __fmul_rn(x, ksc[u]);
          if (lane == 0) s_s[(q0 + j) * chunk + t] = cap(x, p.soft_cap);
        }
      }
    }
  }
  __syncthreads();

  const int64_t row = static_cast<int64_t>(c * p.Hkv + kvh) * NQ;
  const int cap_tokens = p.splits * chunk;
  for (int i = tid; i < NQ * n; i += kAttnThreads) {
    const int qi = i / n;
    const int t = i - qi * n;
    p.logits[(row + qi) * cap_tokens + split * chunk + t] = s_s[qi * chunk + t];
  }
  for (int qi = warp; qi < NQ; qi += kAttnWarps) {
    const int nv = max(0, min(n, len_s[qi / G] - k.off));
    float mx = kMaskValue;
    for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, s_s[qi * chunk + t]);
    mx = warp_max(mx);
    if (lane == 0) p.part_cmax[cmax + qi] = mx;
  }
}

// Pass 2. One CTA per (split, kv head, cache row): the chunk's partial for
// the S x G queries. p = exp(logit - M) with M the running max of the
// chunk's 128-token block as the plain version (and the TPU kernel) sees
// it: the largest chunk maximum of every page up to and including this
// one, in segment order. So p, and p * v_scale for int8 pages, round to
// the same bf16 values as there. A chunk in the slab's last page also
// stands for the blocks past the slab that a longer length re-reads (the
// TPU kernel's behaviour), as further rounds of the same tokens; their
// logits are the last page's, which M already holds, so M stays.
template <bool QUANT>
__global__ void __launch_bounds__(kAttnThreads)
slab_split_kernel(const AttnArgs p) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int c = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int NQ = p.chain * G;
  const int hd = p.hd;
  const int chunk = p.chunk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool active = lane < hd / 8;

  extern __shared__ float smem[];
  float* s_s = smem;                         // [NQ, chunk] logits
  float* pb_s = s_s + NQ * chunk;            // [NQ, chunk] bf16 p (int8 pages: p * v_scale)
  float* acc_s = pb_s + NQ * chunk;          // [NQ, hd]
  float* red = acc_s + NQ * hd;              // [kAttnWarps, kPV, hd]
  float* m_s = red + kAttnWarps * kPV * hd;  // [NQ] the block's running max
  float* l_s = m_s + NQ;                     // [NQ] sum of p
  int* len_s = reinterpret_cast<int*>(l_s + NQ);   // [S] lengths

  const Chunk k = locate(p, split, kvh, c, len_s);
  const int64_t part = (static_cast<int64_t>(c * p.Hkv + kvh) * p.splits + split) * NQ;
  if (k.maxlen <= k.off) {                   // past every length: neutral partial
    for (int i = tid; i < NQ * hd; i += kAttnThreads) p.part_acc[part * hd + i] = 0.f;
    for (int qi = tid; qi < NQ; qi += kAttnThreads) {
      p.part_m[part + qi] = kMaskValue;
      p.part_l[part + qi] = 0.f;
    }
    return;
  }
  const int page = k.off / kBlock;
  const int last = k.sg.T / kBlock - 1;
  const int reps = page == last ? max(1, (k.maxlen + kBlock - 1) / kBlock - last) : 1;
  const int n0 = min(chunk, k.maxlen - k.off);     // tokens of the first round

  // M: the chunk maxima of this cache row and kv head up to this page's end
  const int per_page = kBlock / chunk;
  const int end = (split / per_page + 1) * per_page;
  const int64_t cm0 = static_cast<int64_t>(c * p.Hkv + kvh) * p.splits * NQ;
  for (int qi = warp; qi < NQ; qi += kAttnWarps) {
    float mx = kMaskValue;
    for (int s2 = lane; s2 < end; s2 += 32) mx = fmaxf(mx, p.part_cmax[cm0 + s2 * NQ + qi]);
    mx = warp_max(mx);
    if (lane == 0) {
      m_s[qi] = mx;
      l_s[qi] = 0.f;
    }
  }
  const int64_t row = static_cast<int64_t>(c * p.Hkv + kvh) * NQ;
  const int cap_tokens = p.splits * chunk;
  for (int i = tid; i < NQ * n0; i += kAttnThreads) {
    const int qi = i / n0;
    const int t = i - qi * n0;
    s_s[qi * chunk + t] = p.logits[(row + qi) * cap_tokens + split * chunk + t];
  }
  for (int i = tid; i < NQ * hd; i += kAttnThreads) acc_s[i] = 0.f;
  __syncthreads();

  for (int rep = 0; rep < reps; ++rep) {
    const int v0 = (page + rep) * kBlock + k.off % kBlock;   // position of token 0
    const int n = min(chunk, k.maxlen - v0);
    if (n <= 0) break;

    // p of this round: a warp per query; l takes the unrounded p
    for (int qi = warp; qi < NQ; qi += kAttnWarps) {
      const int nv = max(0, min(n, len_s[qi / G] - v0));
      const float mq = m_s[qi];
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = t < nv ? expf(s_s[qi * chunk + t] - mq) : 0.f;
        sum += e;
        float pt = e;
        if constexpr (QUANT) pt = __fmul_rn(pt, k.sg.vs[k.tok0 + t]);
        pb_s[qi * chunk + t] = bf16_round(pt);
      }
      sum = warp_sum(sum);
      if (lane == 0) l_s[qi] = __fadd_rn(l_s[qi], sum);
    }
    __syncthreads();

    // acc += sum_t p_t * v_t: a warp per token, each lane 8 output dims;
    // the warps' registers summed in a fixed order
    for (int q0 = 0; q0 < NQ; q0 += kPV) {
      float acc[kPV][8];
#pragma unroll
      for (int j = 0; j < kPV; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
      for (int t0 = warp; t0 < n; t0 += kAttnWarps * kBatch) {
        float vv[kBatch][8];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int t = t0 + u * kAttnWarps;
          if (active && t < n) load8<QUANT>(k.sg.v, (k.tok0 + t) * hd + lane * 8, vv[u]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int t = t0 + u * kAttnWarps;
          if (t >= n) break;
#pragma unroll
          for (int j = 0; j < kPV; ++j) {
            if (q0 + j < NQ) {
              const float pt = pb_s[(q0 + j) * chunk + t];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(pt, vv[u][e]));
            }
          }
        }
      }
      if (active) {
#pragma unroll
        for (int j = 0; j < kPV; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) red[(warp * kPV + j) * hd + lane * 8 + e] = acc[j][e];
      }
      __syncthreads();
      const int ng = min(kPV, NQ - q0);
      for (int i = tid; i < ng * hd; i += kAttnThreads) {
        float blk = 0.f;
#pragma unroll
        for (int w = 0; w < kAttnWarps; ++w) blk = __fadd_rn(blk, red[w * kPV * hd + i]);
        acc_s[q0 * hd + i] = __fadd_rn(acc_s[q0 * hd + i], blk);
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < NQ * hd; i += kAttnThreads) p.part_acc[part * hd + i] = acc_s[i];
  for (int qi = tid; qi < NQ; qi += kAttnThreads) {
    p.part_m[part + qi] = m_s[qi];
    p.part_l[part + qi] = l_s[qi];
  }
}

struct MergeArgs {
  const float* q;       // [B, H, hd] the attention's q
  const float* k_cur;   // [B, Hkv, hd] in-flight tokens, or nullptr
  const float* v_cur;
  const float* part_acc;
  const float* part_m;
  const float* part_l;
  int8_t* x8;           // [B, H * hd] the output row's levels
  float* sx;            // [B] and scale
  const int* len[2];    // the segments' lengths [B] (len[1] may be null)
  int T[2];             // and capacities
  int clamp_a;
  int H, Hkv, hd, chain, chunk, splits;
  float soft_cap;
  float* out_f32;       // F32OUT: [B, H * hd] the rows, unquantized
  float* amax;          // F32OUT: [B] each row's absmax
};

// Splits of one query that hold tokens: [0, n_a) of segment A and
// [T[0] / chunk, + n_b) of segment B. The others wrote the neutral partial
// (0, mask, 0), whose weight in the merge is exactly 0 (or, where every
// split is neutral, adds exactly 0), so skipping them changes no bit.
__device__ __forceinline__ void live_splits(const MergeArgs& p, int b, int& n_a, int& n_b) {
  int la = p.len[0][b];
  if (p.clamp_a) la = max(la, 1);
  const int lb = p.len[1] != nullptr ? p.len[1][b] : 0;
  n_a = (min(max(la, 0), p.T[0]) + p.chunk - 1) / p.chunk;
  n_b = (min(max(lb, 0), p.T[1]) + p.chunk - 1) / p.chunk;
}

// One CTA per pseudo-row b, a warp per query head: the partials in split
// order, the in-flight chain j = 0 .. pos_in, acc / (l > 0 ? l : 1); then
// the row's int8 levels and scale (quantize_rows_kernel's arithmetic), or,
// F32OUT (a tensor-parallel rank's heads), the f32 row and its absmax for
// the group's quantization.
template <bool QUANT, bool F32OUT = false>
__global__ void __launch_bounds__(kAttnThreads)
merge_quant_kernel(const MergeArgs p) {
  extern __shared__ float row[];   // [H * hd]
  __shared__ float red[kAttnWarps];
  const int b = blockIdx.x;
  const int G = p.H / p.Hkv;
  const int S = p.chain;
  const int NQ = S * G;
  const int hd = p.hd;
  const int c = b / S;
  const int pos_in = b - c * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int hh = warp; hh < p.H; hh += kAttnWarps) {
    const int kvh = hh / G;
    const int qi = pos_in * G + (hh - kvh * G);
    const int64_t part = static_cast<int64_t>(c * p.Hkv + kvh) * p.splits * NQ + qi;
    int n_a, n_b;
    live_splits(p, b, n_a, n_b);
    const int b0 = p.T[0] / p.chunk - n_a;    // the live splits: k < n_a, then k + b0
    const int n = n_a + n_b;
    float m = kMaskValue;
    for (int k = lane; k < n; k += 32)
      m = fmaxf(m, p.part_m[part + static_cast<int64_t>(k < n_a ? k : k + b0) * NQ]);
    m = warp_max(m);
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    float l = 0.f;
    // kMergeBatch splits' partials loaded before any is summed (one L2
    // round trip a batch, not a split), then summed in split order
    for (int k0 = 0; k0 < n; k0 += kMergeBatch) {
      float ms[kMergeBatch], ls[kMergeBatch], va[kMergeBatch][8];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int k = k0 + j;
        if (k >= n) break;
        const int64_t ps_ = part + static_cast<int64_t>(k < n_a ? k : k + b0) * NQ;
        ms[j] = p.part_m[ps_];
        ls[j] = p.part_l[ps_];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          va[j][i] = lane + 32 * i < hd ? p.part_acc[ps_ * hd + lane + 32 * i] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        if (k0 + j >= n) break;
        const float w = expf(ms[j] - m);
        l = __fadd_rn(l, __fmul_rn(ls[j], w));
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, va[j][i]));
      }
    }
    if (p.k_cur != nullptr) {
      const float* qrow = p.q + (static_cast<int64_t>(b) * p.H + hh) * hd;
      for (int j = 0; j <= pos_in; ++j) {
        const bool self = j == pos_in;
        const int64_t cur_base = (static_cast<int64_t>(c * S + j) * p.Hkv + kvh) * hd;
        float ck[8], cv[8];
        float kmax = 0.f, vmax = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = lane + 32 * i;
          float kx = 0.f, vx = 0.f;
          if (d < hd) {
            kx = p.k_cur[cur_base + d];
            vx = p.v_cur[cur_base + d];
            if (!self) {
              kx = bf16_round(kx);
              vx = bf16_round(vx);
            }
          }
          ck[i] = kx;
          cv[i] = vx;
          kmax = fmaxf(kmax, fabsf(kx));
          vmax = fmaxf(vmax, fabsf(vx));
        }
        if (QUANT && !self) {
          // the int8 page round trip of one token: levels of absmax / 127
          const float ks = act_scale(warp_max(kmax));
          const float vs = act_scale(warp_max(vmax));
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            ck[i] = __fmul_rn(static_cast<float>(quant_level(ck[i], ks)), ks);
            cv[i] = __fmul_rn(static_cast<float>(quant_level(cv[i], vs)), vs);
          }
        }
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) dot = __fadd_rn(dot, __fmul_rn(self ? qrow[d] : bf16_round(qrow[d]), ck[i]));
        }
        const float cur = cap(warp_sum(dot), p.soft_cap);
        const float m_new = fmaxf(m, cur);
        const float pc = expf(cur - m_new);
        const float alpha = expf(m - m_new);
        l = __fadd_rn(__fmul_rn(l, alpha), pc);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha), __fmul_rn(pc, cv[i]));
        m = m_new;
      }
    }
    const float den = l > 0.f ? l : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < hd) row[hh * hd + lane + 32 * i] = acc[i] / den;
  }
  __syncthreads();
  const int ho = p.H * hd;
  float amax = 0.f;
  for (int d = threadIdx.x; d < ho; d += kAttnThreads) amax = fmaxf(amax, fabsf(row[d]));
  if constexpr (F32OUT) {
    for (int d = threadIdx.x; d < ho; d += kAttnThreads)
      p.out_f32[static_cast<int64_t>(b) * ho + d] = row[d];
    amax = block_max(amax, red);
    if (threadIdx.x == 0) p.amax[b] = amax;
    return;
  }
  const float s = act_scale(block_max(amax, red));
  for (int d = threadIdx.x; d < ho; d += kAttnThreads)
    p.x8[static_cast<int64_t>(b) * ho + d] = quant_level(row[d], s);
  if (threadIdx.x == 0) p.sx[b] = s;
}

template <typename Kernel>
cudaError_t launch_pass(Kernel kernel, const AttnArgs& p, size_t smem, int bc, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(p.splits, p.Hkv, bc), kAttnThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t launch_attention(const AttnArgs& p, const MergeArgs& m, int B, bool f32out,
                             cudaStream_t s) {
  const size_t NQ = static_cast<size_t>(p.chain) * (p.H / p.Hkv);
  if (p.splits > 0) {
    const size_t lens = sizeof(int) * p.chain;
    T5G_CHECK(launch_pass(slab_logits_kernel<QUANT>, p,
                          sizeof(float) * NQ * (p.hd + p.chunk) + lens, B / p.chain, s));
    T5G_CHECK(launch_pass(slab_split_kernel<QUANT>, p,
                          sizeof(float) * (NQ * (2 * p.chunk + p.hd + 2) +
                                           static_cast<size_t>(kAttnWarps) * kPV * p.hd) +
                              lens,
                          B / p.chain, s));
  }
  const size_t smem = p.H * p.hd * sizeof(float);
  if (f32out)
    merge_quant_kernel<QUANT, true><<<B, kAttnThreads, smem, s>>>(m);
  else
    merge_quant_kernel<QUANT><<<B, kAttnThreads, smem, s>>>(m);
  return cudaGetLastError();
}

}  // namespace

// The arguments of one call, mirrored field by field by the ctypes
// Structure in ops/megakernel.py (keep the two in the same order).
struct DecodeArgs {
  float* h;                        // [B, D] f32, updated in place (B pseudo-rows)
  const float* cos;                // [B, hd] self-attention rope tables
  const float* sin;
  const float* qcos;               // [B, hd] cross-query rope tables
  const float* qsin;
  const int* plens;                // [B] prompt lengths
  const int* glens;                // [B] generated lengths
  const int* elens;                // [B] encoder lengths
  const int8_t* w[6];              // qkv, o, cross q, cross o, gate_up, down:
                                   // [L, N, K] int8 or [L, N, K / 2] packed int4
  const float* ws[6];              // their scales [L, N]
  const float* norms[6];           // pre/post self, pre/post cross, pre/post ff: [L, D]
  const void* slab[6];             // prompt k/v, gen k/v, cross k/v: [Hkv, L*Bc, T, hd]
  const float* slab_scale[6];      // [Hkv, L*Bc, T] f32 (int8 pages), else null
  float* k_new;                    // [layers run, B, Hkv, hd] f32
  float* v_new;
  int8_t* x8;                      // workspace [B, max(D, H*hd, F)]
  float* sx;                       // workspace [B, max(1, F / ftile)]
  float* proj;                     // workspace [B, max((H + 2 Hkv) hd, 2 F)]
  float* qbuf;                     // workspace [B, H, hd]
  float* dout;                     // workspace [B, D]
  float* attn_logits;              // workspace [Bc, Hkv, chain * G, max(Tp + Tg, Tx)]
  float* part_cmax;                // workspace [Bc, Hkv, splits, chain * G]
  float* part_acc;                 // workspace [Bc, Hkv, splits, chain * G, hd]
  float* part_m;                   // workspace [Bc, Hkv, splits, chain * G]
  float* part_l;
  int B, D, H, Hkv, hd, F, L, ftile, Tp, Tg, Tx, kv_quant;
  int w4;                          // 1: int4 weights
  int chain;                       // pseudo-rows per cache row (B = rows * chain)
  int chunk_self, splits_self;     // the attention plans (ops/megakernel.py::
  int chunk_cross, splits_cross;   // attention_plan); splits = the larger
  float eps, soft_cap, q_scale;
};

// The extra buffers of a tensor-parallel rank's layer parts (run_part),
// mirrored by the ctypes Structure in ops/megakernel.py.
struct PartArgs {
  float* attn;          // [B, H * hd] the attention rows (parts 0, 2 -> 1, 3)
  float* amax;          // [B, max(1, NT)] absmax, local then the group's
  int32_t* isum;        // [B, max(1, NT), D] int32 sums, local then the group's
  float* gbuf;          // [B, F] the GeGLU values (part 4 -> 5)
  int k0;               // this rank's first column of the whole F
  int tile;             // the whole F's activation tile (512, or F when F < 512)
  int NT;               // tiles of the whole F
};

namespace {

cudaError_t norm_step(const DecodeArgs& a, const float* y, const float* w_post,
                      const float* w_pre, cudaStream_t s) {
  const size_t smem = 4 * sizeof(float) * a.D;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        residual_norm_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  residual_norm_quant_kernel<<<a.B, kRowThreads, smem, s>>>(a.h, y, w_post, w_pre, a.D,
                                                            a.eps, a.x8, a.sx);
  return cudaGetLastError();
}

cudaError_t gemv(const DecodeArgs& a, int which, int li, int N, int K, int ktile, float* out,
                 cudaStream_t s) {
  const int64_t layer_bytes = static_cast<int64_t>(N) * (a.w4 ? K / 2 : K);
  GemvArgs p{a.x8, a.sx, a.w[which] + li * layer_bytes,
             a.ws[which] + static_cast<int64_t>(li) * N, out, a.B, N, K, ktile};
  return a.w4 ? launch_gemv<float, true>(p, s) : launch_gemv<float, false>(p, s);
}

// Attention of layer li (self: prompt + generated + the in-flight chain;
// cross: the encoder pages), ending in x8 / sx = quant(attn), or with
// out_f32 in the f32 rows and their absmax amax [B].
cudaError_t attention(const DecodeArgs& a, int li, bool self, const float* k_cur,
                      const float* v_cur, cudaStream_t s, float* out_f32 = nullptr,
                      float* amax = nullptr) {
  const int bc = a.B / a.chain;
  AttnArgs p{};
  p.q = a.qbuf;
  const int first = self ? 0 : 4;
  p.seg[0] = Seg{a.slab[first], a.slab[first + 1], a.slab_scale[first], a.slab_scale[first + 1],
                 self ? a.plens : a.elens, self ? a.Tp : a.Tx};
  p.seg[1] = self ? Seg{a.slab[2], a.slab[3], a.slab_scale[2], a.slab_scale[3], a.glens, a.Tg}
                  : Seg{nullptr, nullptr, nullptr, nullptr, nullptr, 0};
  p.logits = a.attn_logits;
  p.part_cmax = a.part_cmax;
  p.part_acc = a.part_acc;
  p.part_m = a.part_m;
  p.part_l = a.part_l;
  p.LB = a.L * bc;
  p.row0 = li * bc;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.hd = a.hd;
  p.chain = a.chain;
  p.soft_cap = a.soft_cap;
  p.clamp_a = self ? 0 : 1;
  p.chunk = self ? a.chunk_self : a.chunk_cross;
  p.splits = self ? a.splits_self : a.splits_cross;
  const MergeArgs m{a.qbuf, k_cur, v_cur, a.part_acc, a.part_m, a.part_l, a.x8, a.sx,
                    {p.seg[0].len, p.seg[1].len}, {p.seg[0].T, p.seg[1].T}, p.clamp_a,
                    a.H, a.Hkv, a.hd, a.chain, p.chunk, p.splits, a.soft_cap, out_f32, amax};
  const bool f32out = out_f32 != nullptr;
  return a.kv_quant ? launch_attention<true>(p, m, a.B, f32out, s)
                    : launch_attention<false>(p, m, a.B, f32out, s);
}

cudaError_t run_layer(const DecodeArgs& a, int li, int out_li, cudaStream_t s) {
  const int D = a.D, ho = a.H * a.hd, nkv = a.Hkv * a.hd;
  const int nqkv = ho + 2 * nkv;
  const int64_t ld = static_cast<int64_t>(li) * D;
  float* knew = a.k_new + static_cast<int64_t>(out_li) * a.B * nkv;
  float* vnew = a.v_new + static_cast<int64_t>(out_li) * a.B * nkv;

  // self attention
  T5G_CHECK(norm_step(a, nullptr, nullptr, a.norms[0] + ld, s));
  T5G_CHECK(gemv(a, 0, li, nqkv, D, D, a.proj, s));
  rope_kernel<<<dim3(a.B, (nqkv + kRowThreads - 1) / kRowThreads), kRowThreads, 0, s>>>(
      a.proj, nqkv, a.cos, a.sin, a.H, a.Hkv, a.hd, a.q_scale, a.qbuf, knew, vnew);
  T5G_CHECK(cudaGetLastError());
  T5G_CHECK(attention(a, li, true, knew, vnew, s));
  T5G_CHECK(gemv(a, 1, li, D, ho, ho, a.dout, s));
  T5G_CHECK(norm_step(a, a.dout, a.norms[1] + ld, a.norms[2] + ld, s));

  // cross attention
  T5G_CHECK(gemv(a, 2, li, ho, D, D, a.proj, s));
  rope_kernel<<<dim3(a.B, (ho + kRowThreads - 1) / kRowThreads), kRowThreads, 0, s>>>(
      a.proj, ho, a.qcos, a.qsin, a.H, a.Hkv, a.hd, a.q_scale, a.qbuf, nullptr, nullptr);
  T5G_CHECK(cudaGetLastError());
  T5G_CHECK(attention(a, li, false, nullptr, nullptr, s));
  T5G_CHECK(gemv(a, 3, li, D, ho, ho, a.dout, s));
  T5G_CHECK(norm_step(a, a.dout, a.norms[3] + ld, a.norms[4] + ld, s));

  // GeGLU MLP with per-tile activation scales
  T5G_CHECK(gemv(a, 4, li, 2 * a.F, D, D, a.proj, s));
  geglu_quant_kernel<<<dim3(a.F / a.ftile, a.B), kRowThreads, a.ftile * sizeof(float), s>>>(
      a.proj, a.F, a.ftile, a.x8, a.sx);
  T5G_CHECK(cudaGetLastError());
  T5G_CHECK(gemv(a, 5, li, D, a.F, a.ftile, a.dout, s));
  return norm_step(a, a.dout, a.norms[5] + ld, nullptr, s);
}

// ---------------------------------------------------------------------------
// a tensor-parallel rank's layer, in parts
// ---------------------------------------------------------------------------
//
// Under tensor parallelism a rank holds whole heads (H, Hkv of DecodeArgs
// are its own) and F columns k0 .. k0 + F of the intermediate; the
// products qkv, cross q and gate_up are column blocks, o, cross o and down
// row blocks. The one-process layer reads a sum over heads or over F at
// six points, so a rank's layer runs as seven parts, and the host reduces
// over the model group between them:
//
//   part 0  steps 1-5, the attention rows left f32   -> amax [B]    MAX
//   part 1  quant at the group's amax; o as int32     -> isum [B, D] SUM
//   part 2  rescale; step 7; steps 8-11 (cross q, its attention rows)
//                                                     -> amax [B]    MAX
//   part 3  quant; cross o as int32                   -> isum [B, D] SUM
//   part 4  rescale; step 13; gate_up; GeGLU of the
//           local columns                             -> amax [B, NT] MAX
//   part 5  quant per tile at the group's amax; down
//           as int32 per whole-F tile                 -> isum [B, NT, D] SUM
//   part 6  step 16's f32 sum over the tiles in tile order; step 17
//
// The levels, the integer sums and every f32 rounding are the one-process
// layer's (the tile sums are exact in int32 and their f32 sum runs in the
// one-process order), so a rank's h equals the one-process h bit for bit.
// A tile that spans two ranks (F a rank not a multiple of 512, or F < 512)
// is cut at the rank boundary; its absmax and its integer sum come whole
// from the group.


cudaError_t quant_tiles(const DecodeArgs& a, const float* x, int K, int k0, int tile, int NT,
                        const float* amax, cudaStream_t s) {
  quantize_tiles_kernel<float><<<a.B, kRowThreads, 0, s>>>(x, K, k0, tile, NT, amax, a.x8, a.sx);
  return cudaGetLastError();
}

cudaError_t gemv_int(const DecodeArgs& a, int which, int li, int N, int K, int k0, int tile,
                     int NT, int32_t* out, cudaStream_t s) {
  const int64_t layer_bytes = static_cast<int64_t>(N) * (a.w4 ? K / 2 : K);
  GemvIntArgs p{a.x8, a.w[which] + li * layer_bytes, out, a.B, N, K, k0, tile, NT};
  return a.w4 ? launch_gemv_int<true>(p, s) : launch_gemv_int<false>(p, s);
}

cudaError_t rescale(const DecodeArgs& a, const PartArgs& t, int which, int li, int NT,
                    cudaStream_t s) {
  return launch_rescale_tiles<float>(t.isum, a.sx, a.ws[which] + static_cast<int64_t>(li) * a.D,
                                     a.B, NT, a.D, a.dout, s);
}

cudaError_t run_part(const DecodeArgs& a, const PartArgs& t, int li, int part, cudaStream_t s) {
  const int D = a.D, ho = a.H * a.hd, nkv = a.Hkv * a.hd;
  const int nqkv = ho + 2 * nkv;
  const int64_t ld = static_cast<int64_t>(li) * D;
  switch (part) {
    case 0:
      T5G_CHECK(norm_step(a, nullptr, nullptr, a.norms[0] + ld, s));
      T5G_CHECK(gemv(a, 0, li, nqkv, D, D, a.proj, s));
    {
      // k_new / v_new are [L, B, Hkv, hd]: layer li's slice
      float* knew = a.k_new + static_cast<int64_t>(li) * a.B * nkv;
      float* vnew = a.v_new + static_cast<int64_t>(li) * a.B * nkv;
      rope_kernel<<<dim3(a.B, (nqkv + kRowThreads - 1) / kRowThreads), kRowThreads, 0, s>>>(
          a.proj, nqkv, a.cos, a.sin, a.H, a.Hkv, a.hd, a.q_scale, a.qbuf, knew, vnew);
      T5G_CHECK(cudaGetLastError());
      return attention(a, li, true, knew, vnew, s, t.attn, t.amax);
    }
    case 1:
    case 3:
      T5G_CHECK(quant_tiles(a, t.attn, ho, 0, ho, 1, t.amax, s));
      return gemv_int(a, part == 1 ? 1 : 3, li, D, ho, 0, ho, 1, t.isum, s);
    case 2:
      T5G_CHECK(rescale(a, t, 1, li, 1, s));
      T5G_CHECK(norm_step(a, a.dout, a.norms[1] + ld, a.norms[2] + ld, s));
      T5G_CHECK(gemv(a, 2, li, ho, D, D, a.proj, s));
      rope_kernel<<<dim3(a.B, (ho + kRowThreads - 1) / kRowThreads), kRowThreads, 0, s>>>(
          a.proj, ho, a.qcos, a.qsin, a.H, a.Hkv, a.hd, a.q_scale, a.qbuf, nullptr, nullptr);
      T5G_CHECK(cudaGetLastError());
      return attention(a, li, false, nullptr, nullptr, s, t.attn, t.amax);
    case 4: {
      T5G_CHECK(rescale(a, t, 3, li, 1, s));
      T5G_CHECK(norm_step(a, a.dout, a.norms[3] + ld, a.norms[4] + ld, s));
      T5G_CHECK(gemv(a, 4, li, 2 * a.F, D, D, a.proj, s));
      T5G_CHECK(cudaMemsetAsync(t.amax, 0, sizeof(float) * a.B * t.NT, s));
      const int touched = (t.k0 + a.F - 1) / t.tile - t.k0 / t.tile + 1;
      geglu_part_kernel<<<dim3(touched, a.B), kRowThreads, 0, s>>>(a.proj, a.F, t.k0, t.tile, t.NT,
                                                                  t.gbuf, t.amax);
      return cudaGetLastError();
    }
    case 5:
      T5G_CHECK(quant_tiles(a, t.gbuf, a.F, t.k0, t.tile, t.NT, t.amax, s));
      T5G_CHECK(cudaMemsetAsync(t.isum, 0, sizeof(int32_t) * a.B * t.NT * D, s));
      return gemv_int(a, 5, li, D, a.F, t.k0, t.tile, t.NT, t.isum, s);
    case 6:
      T5G_CHECK(rescale(a, t, 5, li, t.NT, s));
      return norm_step(a, a.dout, a.norms[5] + ld, nullptr, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool plan_fits(int chunk, int splits, int capacity) {
  return chunk > 0 && kBlock % chunk == 0 &&
         static_cast<int64_t>(chunk) * splits == capacity;
}

cudaError_t run_layers(const DecodeArgs& a, int layer0, int n_layers, cudaStream_t s) {
  if (a.hd % 8 || a.hd > 256 || a.H % a.Hkv || a.F % a.ftile || a.ftile % 16 ||
      a.chain < 1 || a.B % a.chain ||
      a.D * sizeof(float) > 48 * 1024 || a.ftile * sizeof(float) > 48 * 1024 ||
      a.H * a.hd * sizeof(float) > 48 * 1024 ||
      !plan_fits(a.chunk_self, a.splits_self, a.Tp + a.Tg) ||
      !plan_fits(a.chunk_cross, a.splits_cross, a.Tx))
    return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  for (int i = 0; i < n_layers; ++i) T5G_CHECK(run_layer(a, layer0 + i, i, s));
  return cudaSuccess;
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns a cudaError_t code.
// t5g_decode_layer runs layer li (k_new/v_new hold one layer);
// t5g_decode_stack runs all L layers in order in one call.
extern "C" int t5g_decode_layer(const DecodeArgs* a, int li, void* stream) {
  return static_cast<int>(run_layers(*a, li, 1, static_cast<cudaStream_t>(stream)));
}

extern "C" int t5g_decode_stack(const DecodeArgs* a, void* stream) {
  return static_cast<int>(run_layers(*a, 0, a->L, static_cast<cudaStream_t>(stream)));
}

// Part `part` (0-6) of layer li of a tensor-parallel rank (run_part);
// k_new / v_new hold all L layers. With chain = S > 1 every part runs over
// the B = Bc * S pseudo-rows as run_layers does (the attention reads each
// cache row's slabs once for its chain, the merge folds in the chain
// prefix), and the host reduces over the same pseudo-rows.
extern "C" int t5g_decode_layer_part(const DecodeArgs* a, const PartArgs* t, int li, int part,
                                     void* stream) {
  const DecodeArgs& d = *a;
  if (d.hd % 8 || d.hd > 256 || d.H % d.Hkv || d.chain < 1 || d.B % d.chain || d.F % 16 ||
      (d.H * d.hd) % 16 || t->k0 % 16 || t->tile % 16 || t->tile <= 0 ||
      (t->k0 + d.F + t->tile - 1) / t->tile > t->NT || li < 0 || li >= d.L ||
      d.D * sizeof(float) > 48 * 1024 || d.H * d.hd * sizeof(float) > 48 * 1024 ||
      !plan_fits(d.chunk_self, d.splits_self, d.Tp + d.Tg) ||
      !plan_fits(d.chunk_cross, d.splits_cross, d.Tx))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d.B == 0) return 0;
  return static_cast<int>(run_part(d, *t, li, part, static_cast<cudaStream_t>(stream)));
}
