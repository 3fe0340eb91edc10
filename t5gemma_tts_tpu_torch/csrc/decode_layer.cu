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
//   4  self attention: prompt + generated + in-flight token
//   5  a8, sa = quant(attn)                        quantize_rows
//   6  o = (f32(a8 @ Wo) * sa) * s                 w8a8_gemv, exact int32 over K
//   7  h += rms(o, n1); x8, sx = quant(rms(h, n2)) residual_norm_quant
//   8  cq = W8A8 cross q; 9 rope(qcos, qsin) * q_scale
//   10 cross attention (encoder pages, length clamped to >= 1, no current)
//   11-12 quant, W8A8 cross o; 13 h += rms(., n3); x8 = quant(rms(h, n4))
//   14 gu = W8A8 gate_up (gate columns, then up columns)
//   15 per 512-wide F tile j (one tile of width F when F < 512):
//        t = gelu_tanh(g_j) * u_j; t8_j, st_j = quant(t_j)   geglu_quant
//   16 acc = sum_j f32(t8_j @ Wd_j) * st_j in tile order; d = acc * s_down
//   17 h += rms(d, n5)
//
// The six products (steps 2, 6, 8, 12, 14, 16) read int8 levels [N, K] or,
// with DecodeArgs::w4, packed int4 levels [N, K / 2] through the same GEMV
// (w8a8.cuh, template parameter W4), which unpacks the nibbles in
// registers; the integer sums are exact either way, so the int4 layer is
// the int8 layer's arithmetic on other levels. The TPU variant's doubled
// DMA chunk and its ones-matrix sum(x8) dot are Mosaic workarounds with no
// counterpart here.
//
// Attention (slab_attention_kernel) follows the megakernel, not kernel 1:
// q is rounded to bf16 for the page dots, p (int8 pages: p * v_scale) is
// rounded to bf16 before the PV dot, int8 logits are multiplied by the k
// scale after the dot, the soft cap comes before the -0.7 * FLT_MAX mask,
// the online softmax advances by 128-token blocks, and the in-flight token
// joins last with the unrounded f32 q. Page addressing is the cache's
// identity slab layout: layer li, cache row c is slab row li * Bc + c.
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
// step by the GEMVs (see w8a8.cuh), plus the valid K/V bytes. Rounding and the rescales use
// __fmul_rn / __fadd_rn (no fused multiply-add), so every elementwise
// step gives the plain PyTorch version's bits; only sums differ in order.
// A single persistent kernel per step is later work.

#include "w8a8.cuh"

namespace {

using namespace t5g;

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kBlock = 128;        // attention time block (= page size)
constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kGroup = 8;          // queries handled together in registers

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float cap(float x, float soft_cap) {
  return soft_cap > 0.f ? __fmul_rn(tanhf(x / soft_cap), soft_cap) : x;
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
// x8[b], sx[b] = quant(rms(h[b], w_pre)).
__global__ void __launch_bounds__(kRowThreads)
residual_norm_quant_kernel(float* h, const float* y, const float* w_post, const float* w_pre,
                           int D, float eps, int8_t* x8, float* sx) {
  extern __shared__ float row[];   // [D]
  __shared__ float red[kRowThreads / 32];
  const int64_t b = blockIdx.x;
  float* hb = h + b * D;
  if (y != nullptr) {
    const float* yb = y + b * D;
    float ss = 0.f;
    for (int d = threadIdx.x; d < D; d += kRowThreads) ss = __fadd_rn(ss, __fmul_rn(yb[d], yb[d]));
    const float r = row_rsqrt(block_sum(ss, red), D, eps);
    for (int d = threadIdx.x; d < D; d += kRowThreads) {
      const float n = __fmul_rn(__fmul_rn(yb[d], r), __fadd_rn(1.f, w_post[d]));
      row[d] = __fadd_rn(hb[d], n);
      hb[d] = row[d];
    }
  } else {
    for (int d = threadIdx.x; d < D; d += kRowThreads) row[d] = hb[d];
  }
  if (w_pre == nullptr) return;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kRowThreads) ss = __fadd_rn(ss, __fmul_rn(row[d], row[d]));
  const float r = row_rsqrt(block_sum(ss, red), D, eps);
  float amax = 0.f;
  for (int d = threadIdx.x; d < D; d += kRowThreads) {
    row[d] = __fmul_rn(__fmul_rn(row[d], r), __fadd_rn(1.f, w_pre[d]));
    amax = fmaxf(amax, fabsf(row[d]));
  }
  const float s = act_scale(block_max(amax, red));
  for (int d = threadIdx.x; d < D; d += kRowThreads) x8[b * D + d] = quant_level(row[d], s);
  if (threadIdx.x == 0) sx[b] = s;
}

// One block per row b of src [B, src_stride]: the H query heads are roped
// and scaled into q_out [B, H, hd]; with k_out, the Hkv key heads that
// follow are roped into k_out [B, Hkv, hd] and the value heads copied into
// v_out. rope(x)[d] = x[d] * cos[d] + rot_half(x)[d] * sin[d].
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
  for (int i = threadIdx.x; i < total; i += kRowThreads) {
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

struct Seg {
  const void* k;        // [Hkv, L*B, T, hd] bf16 or int8
  const void* v;
  const float* ks;      // [Hkv, L*B, T] (int8 pages only)
  const float* vs;
  const int* len;       // [B]; nullptr = segment absent
  int T;                // slab capacity, a multiple of kBlock
};

struct AttnArgs {
  const float* q;       // [B, H, hd] roped and scaled, f32
  const float* k_cur;   // [B, Hkv, hd] in-flight tokens, or nullptr
  const float* v_cur;
  Seg seg[2];
  float* out;           // [B, H * hd]
  int B, LB, row0, H, Hkv, hd;
  int chain;            // pseudo-rows per cache row
  float soft_cap;       // <= 0: no cap
  int clamp_a;          // segment A length clamped to >= 1
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

template <bool QUANT>
__device__ __forceinline__ float load1(const void* base, int64_t off) {
  if constexpr (QUANT) return static_cast<float>(reinterpret_cast<const int8_t*>(base)[off]);
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[off]);
}

// One CTA per (row b, kv head): flash attention over the row's blocks of
// segment A, then segment B, then the in-flight token.
template <bool QUANT>
__global__ void __launch_bounds__(kAttnThreads)
slab_attention_kernel(const AttnArgs p) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int hd = p.hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nchunks = hd / 8;

  extern __shared__ float smem[];
  float* q_s = smem;               // [G, hd] f32 q
  float* qb_s = q_s + G * hd;      // [G, hd] q rounded to bf16
  float* acc_s = qb_s + G * hd;    // [G, hd]
  float* s_s = acc_s + G * hd;     // [G, kBlock] logits, then probabilities
  float* m_s = s_s + G * kBlock;   // [G] running max
  float* l_s = m_s + G;            // [G] running sum
  float* a_s = l_s + G;            // [G] rescale of this block
  float* ck_s = a_s + G;           // [hd] a chain position's k
  float* cv_s = ck_s + hd;         // [hd] and v
  float* red = cv_s + hd;          // [kAttnWarps] block reductions

  const int64_t q_base = (static_cast<int64_t>(b) * p.H + kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kAttnThreads) {
    q_s[i] = p.q[q_base + i];
    qb_s[i] = bf16_round(q_s[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kAttnThreads) {
    m_s[g] = kMaskValue;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int si = 0; si < 2; ++si) {
    const Seg& S = p.seg[si];
    if (S.len == nullptr) continue;
    int len = S.len[b];
    if (si == 0 && p.clamp_a) len = max(len, 1);
    const int nblocks = (len + kBlock - 1) / kBlock;
    const int pages = S.T / kBlock;
    const int64_t slab0 = (static_cast<int64_t>(kvh) * p.LB + p.row0 + b / p.chain) * S.T;
    for (int i = 0; i < nblocks; ++i) {
      // a length past the slab re-reads its last page, as the TPU kernel does
      const int64_t tok0 = slab0 + static_cast<int64_t>(min(i, pages - 1)) * kBlock;
      const int nvalid = min(kBlock, len - i * kBlock);

      // logits: one warp per token, one 8-element chunk of hd per lane
      for (int t = warp; t < nvalid; t += kAttnWarps) {
        float kv[8];
        const bool active = lane < nchunks;
        if (active) load8<QUANT>(S.k, (tok0 + t) * hd + lane * 8, kv);
        float ksc = 1.f;
        if constexpr (QUANT) ksc = S.ks[tok0 + t];
        for (int g0 = 0; g0 < G; g0 += kGroup) {
          float part[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            part[j] = 0.f;
            if (active && g0 + j < G) {
              const float* qg = qb_s + (g0 + j) * hd + lane * 8;
#pragma unroll
              for (int e = 0; e < 8; ++e) part[j] = __fadd_rn(part[j], __fmul_rn(qg[e], kv[e]));
            }
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            float x = part[j];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
            if constexpr (QUANT) x = __fmul_rn(x, ksc);
            if (lane == 0 && g0 + j < G) s_s[(g0 + j) * kBlock + t] = cap(x, p.soft_cap);
          }
        }
      }
      __syncthreads();

      // online softmax update of this block: one warp per query
      for (int g = warp; g < G; g += kAttnWarps) {
        float* sg = s_s + g * kBlock;
        float mx = kMaskValue;
        for (int t = lane; t < nvalid; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < kBlock; t += 32) {
          const float e = t < nvalid ? expf(sg[t] - m_new) : 0.f;
          sg[t] = e;
          sum += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[g] = alpha;
          l_s[g] = __fadd_rn(__fmul_rn(l_s[g], alpha), sum);
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + sum_t bf16(p_t [* vs_t]) * v_t
      for (int d = tid; d < hd; d += kAttnThreads) {
        for (int g0 = 0; g0 < G; g0 += kGroup) {
          float blk[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) blk[j] = 0.f;
          for (int t = 0; t < nvalid; ++t) {
            const float v = load1<QUANT>(S.v, (tok0 + t) * hd + d);
            float vsc = 1.f;
            if constexpr (QUANT) vsc = S.vs[tok0 + t];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
              if (g0 + j < G) {
                float pt = s_s[(g0 + j) * kBlock + t];
                if constexpr (QUANT) pt = __fmul_rn(pt, vsc);
                blk[j] = __fadd_rn(blk[j], __fmul_rn(bf16_round(pt), v));
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (g0 + j < G) {
              float* a = acc_s + (g0 + j) * hd + d;
              *a = __fadd_rn(__fmul_rn(*a, a_s[g0 + j]), blk[j]);
            }
        }
      }
      __syncthreads();
    }
  }

  if (p.k_cur != nullptr) {
    // the in-flight chain joins last: positions j = 0 .. pos_in of this
    // pseudo-row's chain (chain 1: the one in-flight token, j = 0 = pos_in)
    const int cb = (b / p.chain) * p.chain;
    const int pos_in = b - cb;
    for (int j = 0; j <= pos_in; ++j) {
      const bool self = j == pos_in;
      const int64_t cur_base = (static_cast<int64_t>(cb + j) * p.Hkv + kvh) * hd;
      float kmax = 0.f, vmax = 0.f;
      for (int d = tid; d < hd; d += kAttnThreads) {
        float kx = p.k_cur[cur_base + d], vx = p.v_cur[cur_base + d];
        if (!self) {
          kx = bf16_round(kx);
          vx = bf16_round(vx);
        }
        ck_s[d] = kx;
        cv_s[d] = vx;
        kmax = fmaxf(kmax, fabsf(kx));
        vmax = fmaxf(vmax, fabsf(vx));
      }
      if (QUANT && !self) {
        // the int8 page round trip of one token: levels of absmax / 127
        const float ks = act_scale(block_max(kmax, red));
        const float vs = act_scale(block_max(vmax, red));
        for (int d = tid; d < hd; d += kAttnThreads) {
          ck_s[d] = __fmul_rn(static_cast<float>(quant_level(ck_s[d], ks)), ks);
          cv_s[d] = __fmul_rn(static_cast<float>(quant_level(cv_s[d], vs)), vs);
        }
      }
      __syncthreads();
      const float* qsel = self ? q_s : qb_s;
      for (int g = warp; g < G; g += kAttnWarps) {
        float part = 0.f;
        for (int d = lane; d < hd; d += 32)
          part = __fadd_rn(part, __fmul_rn(qsel[g * hd + d], ck_s[d]));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        const float cur = cap(part, p.soft_cap);
        if (lane == 0) {
          const float m_old = m_s[g];
          const float m_new = fmaxf(m_old, cur);
          const float pc = expf(cur - m_new);
          const float alpha = expf(m_old - m_new);
          l_s[g] = __fadd_rn(__fmul_rn(l_s[g], alpha), pc);
          m_s[g] = m_new;
          a_s[g] = alpha;
          s_s[g * kBlock] = pc;
        }
      }
      __syncthreads();
      for (int i = tid; i < G * hd; i += kAttnThreads) {
        const int g = i / hd;
        acc_s[i] = __fadd_rn(__fmul_rn(acc_s[i], a_s[g]),
                             __fmul_rn(s_s[g * kBlock], cv_s[i - g * hd]));
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < G * p.hd; i += kAttnThreads) {
    const float l = l_s[i / hd];
    p.out[q_base + i] = acc_s[i] / (l > 0.f ? l : 1.f);
  }
}

template <bool QUANT>
cudaError_t launch_attention(const AttnArgs& p, cudaStream_t s) {
  const int G = p.H / p.Hkv;
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(G) * p.hd +
                                       static_cast<size_t>(G) * kBlock + 3 * G +
                                       2 * p.hd + kAttnWarps);
  auto kernel = slab_attention_kernel<QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(p.B, p.Hkv), kAttnThreads, smem, s>>>(p);
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
  const void* slab[6];             // prompt k/v, gen k/v, cross k/v: [Hkv, L*B, T, hd]
  const float* slab_scale[6];      // [Hkv, L*B, T] f32 (int8 pages), else null
  float* k_new;                    // [layers run, B, Hkv, hd] f32
  float* v_new;
  int8_t* x8;                      // workspace [B, max(D, H*hd, F)]
  float* sx;                       // workspace [B, max(1, F / ftile)]
  float* proj;                     // workspace [B, max((H + 2 Hkv) hd, 2 F)]
  float* qbuf;                     // workspace [B, H, hd]
  float* attn;                     // workspace [B, H * hd]
  float* dout;                     // workspace [B, D]
  int B, D, H, Hkv, hd, F, L, ftile, Tp, Tg, Tx, kv_quant;
  int w4;                          // 1: int4 weights
  int chain;                       // pseudo-rows per cache row (B = rows * chain)
  float eps, soft_cap, q_scale;
};

namespace {

#define T5G_CHECK(x)                          \
  do {                                        \
    const cudaError_t e_ = (x);               \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

cudaError_t norm_step(const DecodeArgs& a, const float* y, const float* w_post,
                      const float* w_pre, cudaStream_t s) {
  residual_norm_quant_kernel<<<a.B, kRowThreads, a.D * sizeof(float), s>>>(
      a.h, y, w_post, w_pre, a.D, a.eps, a.x8, a.sx);
  return cudaGetLastError();
}

cudaError_t gemv(const DecodeArgs& a, int which, int li, int N, int K, int ktile, float* out,
                 cudaStream_t s) {
  const int64_t layer_bytes = static_cast<int64_t>(N) * (a.w4 ? K / 2 : K);
  GemvArgs p{a.x8, a.sx, a.w[which] + li * layer_bytes,
             a.ws[which] + static_cast<int64_t>(li) * N, out, a.B, N, K, ktile};
  return a.w4 ? launch_gemv<float, true>(p, s) : launch_gemv<float, false>(p, s);
}

cudaError_t attention(const DecodeArgs& a, int li, bool self, const float* k_cur,
                      const float* v_cur, cudaStream_t s) {
  AttnArgs p{};
  p.q = a.qbuf;
  p.k_cur = k_cur;
  p.v_cur = v_cur;
  const int first = self ? 0 : 4;
  p.seg[0] = Seg{a.slab[first], a.slab[first + 1], a.slab_scale[first], a.slab_scale[first + 1],
                 self ? a.plens : a.elens, self ? a.Tp : a.Tx};
  p.seg[1] = self ? Seg{a.slab[2], a.slab[3], a.slab_scale[2], a.slab_scale[3], a.glens, a.Tg}
                  : Seg{nullptr, nullptr, nullptr, nullptr, nullptr, 0};
  p.out = a.attn;
  p.B = a.B;
  p.LB = a.L * (a.B / a.chain);
  p.row0 = li * (a.B / a.chain);
  p.chain = a.chain;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.hd = a.hd;
  p.soft_cap = a.soft_cap;
  p.clamp_a = self ? 0 : 1;
  return a.kv_quant ? launch_attention<true>(p, s) : launch_attention<false>(p, s);
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
  rope_kernel<<<a.B, kRowThreads, 0, s>>>(a.proj, nqkv, a.cos, a.sin, a.H, a.Hkv, a.hd,
                                         a.q_scale, a.qbuf, knew, vnew);
  T5G_CHECK(cudaGetLastError());
  T5G_CHECK(attention(a, li, true, knew, vnew, s));
  T5G_CHECK(launch_quantize_rows<float>(a.attn, ho, a.B, ho, a.x8, a.sx, s));
  T5G_CHECK(gemv(a, 1, li, D, ho, ho, a.dout, s));
  T5G_CHECK(norm_step(a, a.dout, a.norms[1] + ld, a.norms[2] + ld, s));

  // cross attention
  T5G_CHECK(gemv(a, 2, li, ho, D, D, a.proj, s));
  rope_kernel<<<a.B, kRowThreads, 0, s>>>(a.proj, ho, a.qcos, a.qsin, a.H, a.Hkv, a.hd,
                                         a.q_scale, a.qbuf, nullptr, nullptr);
  T5G_CHECK(cudaGetLastError());
  T5G_CHECK(attention(a, li, false, nullptr, nullptr, s));
  T5G_CHECK(launch_quantize_rows<float>(a.attn, ho, a.B, ho, a.x8, a.sx, s));
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

cudaError_t run_layers(const DecodeArgs& a, int layer0, int n_layers, cudaStream_t s) {
  if (a.hd % 8 || a.hd > 256 || a.H % a.Hkv || a.F % a.ftile || a.ftile % 16 ||
      a.chain < 1 || a.B % a.chain ||
      a.D * sizeof(float) > 48 * 1024 || a.ftile * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
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
