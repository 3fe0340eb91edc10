// Two-segment paged decode attention for Hopper (sm_90a), split over CTAs.
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/fused_attn.py::_batch_kernel
// (reached through batch_paged_attention). It computes, for each batch row
// and query head, flash attention over the row's valid pages of segment A,
// then of segment B, then optionally the in-flight token, and writes the
// normalized f32 output:
//
//   logits = q . k            (q arrives roped and pre-scaled)
//   logits = tanh(logits / cap) * cap        (soft cap BEFORE the mask)
//   masked logits = -0.7 * FLT_MAX, masked probabilities = 0
//   out = acc / (l > 0 ? l : 1)
//
// Pages are [Hkv, NP, ps, hd], bf16, float8 e4m3 (widened exactly to f32,
// no scales), or int8 with per-token f32 scales [Hkv, NP, ps] (dequantized
// here as int8 * scale[token]). Page ids come from page_indices[b, i];
// nothing assumes identity paging. Segment A's length is clamped to >= 1,
// and tokens past a segment's pages_per_row * ps are not read.
//
// Bound: the bytes of the K/V pages (and scales) that it reads. At decode
// batch sizes a row holds a few pages, and B x Hkv (row, kv head) pairs are
// 4-16 CTAs on a card of 132 SMs, so the design is split-KV:
//
//   split_kernel  one CTA per (split, kv head, row). The host's plan cuts
//                 the capacity of both segments (their pages_per_row * ps
//                 tokens, never the lengths, so the launch needs no host
//                 sync and a CUDA graph can capture it) into chunks of
//                 `chunk` tokens, a divisor of the page, as many as make
//                 B x Hkv x splits fill a wave. A CTA reads its chunk's K
//                 and V once for the G = H / Hkv queries of its kv head and
//                 writes an unnormalized partial (acc, m, l); a chunk past
//                 the row's length writes the neutral (0, mask, 0).
//   merge_kernel  one CTA per row, a warp per query head: the partials of
//                 the splits that hold the row's tokens in split order (the
//                 rest are exactly neutral), the in-flight token, acc / l.
//
// Inside a CTA every step keeps neighbouring lanes on neighbouring bytes:
// logits take a warp per token, each lane one 8-element chunk of hd (16
// bytes of bf16, 8 of int8 or e4m3), and reduce only the G real queries;
// P.V takes a warp per token too, each lane owning 8 output dims and
// reading a V row with the same vector load, so a warp accumulates its
// tokens in registers and a fixed-order shared-memory sum across warps ends
// the chunk (the sums do not depend on the run). Each warp issues the loads
// of kBatch tokens before it computes on any of them. p stays f32.

#include "paged_pages.cuh"

namespace {

using namespace t5g_pages;

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;   // logits: queries per register group
constexpr int kPV = 4;      // P.V: queries per register group
constexpr int kBatch = 4;   // tokens a warp loads before it computes
constexpr int kMergeBatch = 8;   // splits a merge warp loads before it sums

struct Segment {
  const void* k;        // [Hkv, NP, ps, hd] bf16, int8 or e4m3
  const void* v;
  const float* k_scale; // [Hkv, NP, ps] (int8 pages only)
  const float* v_scale;
  const int* lengths;   // [B]; nullptr = segment absent
  const int* pages;     // [B, pages_per_row]
  int pages_per_row;
  int64_t num_pages;    // NP
};

struct Params {
  const float* q;       // [B, H, hd]
  const float* k_cur;   // [B, Hkv, hd] (include_current only)
  const float* v_cur;
  Segment seg[2];
  float* out;           // [B, H, hd]
  float* part_acc;      // [B, Hkv, splits, G, hd] unnormalized partials
  float* part_m;        // [B, Hkv, splits, G]
  float* part_l;
  int H, Hkv, hd, ps;
  float soft_cap;       // <= 0: no cap
  int include_current;
  int chunk, splits;    // the host's plan: splits * chunk = (PPa + PPb) * ps
};

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

__device__ __forceinline__ float cap(float x, float soft_cap) {
  return soft_cap > 0.f ? tanhf(x / soft_cap) * soft_cap : x;
}

template <int PT>
__device__ __forceinline__ void load_row(const void* base, const float* scale, int64_t tok,
                                         int hd, int lane, float* out) {
  load8<PT>(base, tok * hd + lane * 8, out);
  if constexpr (PT == kInt8) {
    const float sc = scale[tok];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] *= sc;
  }
}

template <int PT>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Params p) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int hd = p.hd;
  const int ps = p.ps;
  const int chunk = p.chunk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool active = lane < hd / 8;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [G, hd]
  float* s_s = q_s + G * hd;         // [G, chunk] logits, then probabilities
  float* red = s_s + G * chunk;      // [kWarps, kPV, hd] each warp's P.V

  // this chunk's segment and first token (chunks never straddle a page)
  const int cap_a = p.seg[0].pages_per_row * ps;
  const int tok = split * chunk;
  const bool in_b = tok >= cap_a;
  const Segment S = in_b ? p.seg[1] : p.seg[0];
  const int off = in_b ? tok - cap_a : tok;
  int len = S.lengths[b];
  if (!in_b) len = max(len, 1);      // segment A is clamped to >= 1
  len = min(len, S.pages_per_row * ps);
  const int n = min(chunk, len - off);   // valid tokens of this chunk

  const int64_t part = (static_cast<int64_t>(b * p.Hkv + kvh) * p.splits + split) * G;
  if (n <= 0) {                      // past the row's length: neutral partial
    for (int i = tid; i < G * hd; i += kThreads) p.part_acc[part * hd + i] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      p.part_m[part + g] = kMaskValue;
      p.part_l[part + g] = 0.f;
    }
    return;
  }
  const int pid = S.pages[static_cast<int64_t>(b) * S.pages_per_row + off / ps];
  const int64_t row0 = (static_cast<int64_t>(kvh) * S.num_pages + pid) * ps + off % ps;

  const int64_t q_base = (static_cast<int64_t>(b) * p.H + kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = p.q[q_base + i];
  __syncthreads();

  // logits: a warp per token, kBatch tokens' K rows loaded first
  for (int t0 = warp; t0 < n; t0 += kWarps * kBatch) {
    float kv[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kWarps;
      if (active && t < n) load_row<PT>(S.k, S.k_scale, row0 + t, hd, lane, kv[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kWarps;
      if (t >= n) break;
      for (int g0 = 0; g0 < G; g0 += kGroup) {
        float part_g[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          part_g[j] = 0.f;
          if (active && g0 + j < G) {
            const float* qg = q_s + (g0 + j) * hd + lane * 8;
#pragma unroll
            for (int e = 0; e < 8; ++e) part_g[j] += qg[e] * kv[u][e];
          }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (g0 + j >= G) break;
          const float x = warp_sum(part_g[j]);
          if (lane == 0) s_s[(g0 + j) * chunk + t] = cap(x, p.soft_cap);
        }
      }
    }
  }
  __syncthreads();

  // the chunk's softmax statistics: a warp per query
  for (int g = warp; g < G; g += kWarps) {
    float* sg = s_s + g * chunk;
    float mx = kMaskValue;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sg[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(sg[t] - mx);
      sg[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      p.part_m[part + g] = mx;
      p.part_l[part + g] = sum;
    }
  }
  __syncthreads();

  // P.V: a warp per token, each lane 8 output dims; then a fixed-order sum
  // of the warps' registers through shared memory
  for (int g0 = 0; g0 < G; g0 += kPV) {
    float acc[kPV][8];
#pragma unroll
    for (int j = 0; j < kPV; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
    for (int t0 = warp; t0 < n; t0 += kWarps * kBatch) {
      float vv[kBatch][8];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + u * kWarps;
        if (active && t < n) load_row<PT>(S.v, S.v_scale, row0 + t, hd, lane, vv[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + u * kWarps;
        if (t >= n) break;
#pragma unroll
        for (int j = 0; j < kPV; ++j) {
          if (g0 + j < G) {
            const float pt = s_s[(g0 + j) * chunk + t];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[j][e] += pt * vv[u][e];
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
    const int ng = min(kPV, G - g0);
    for (int i = tid; i < ng * hd; i += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w * kPV * hd + i];
      p.part_acc[(part + g0) * hd + i] = sum;
    }
    __syncthreads();
  }
}

// One CTA per row, a warp per query head: the partials in split order, the
// in-flight token, acc / l.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const Params p) {
  const int b = blockIdx.x;
  const int G = p.H / p.Hkv;
  const int hd = p.hd;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int hh = warp; hh < p.H; hh += kWarps) {
    const int kvh = hh / G;
    const int g = hh - kvh * G;
    const int64_t part = static_cast<int64_t>(b * p.Hkv + kvh) * p.splits * G + g;
    // the splits that hold the row's tokens; the others wrote the neutral
    // partial, whose weight is exactly 0 (or adds exactly 0), so skipping
    // them changes no bit
    const int cap_a = p.seg[0].pages_per_row * p.ps;
    const int n_a = (min(max(p.seg[0].lengths[b], 1), cap_a) + p.chunk - 1) / p.chunk;
    const int n_b = p.seg[1].lengths == nullptr ? 0
        : (min(max(p.seg[1].lengths[b], 0), p.seg[1].pages_per_row * p.ps) + p.chunk - 1) /
              p.chunk;
    const int b0 = cap_a / p.chunk - n_a;     // the live splits: k < n_a, then k + b0
    float m = kMaskValue;
    for (int k = lane; k < n_a + n_b; k += 32)
      m = fmaxf(m, p.part_m[part + static_cast<int64_t>(k < n_a ? k : k + b0) * G]);
    m = warp_max(m);
    const int64_t row = (static_cast<int64_t>(b) * p.H + hh) * hd;
    const int64_t cur_base = (static_cast<int64_t>(b) * p.Hkv + kvh) * hd;
    float cur = 0.f;
    if (p.include_current) {
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += p.q[row + d] * p.k_cur[cur_base + d];
      cur = cap(warp_sum(dot), p.soft_cap);
      m = fmaxf(m, cur);
    }
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    float l = 0.f;
    // kMergeBatch splits' partials loaded before any is summed (one L2
    // round trip a batch, not a split), then summed in split order
    const int n = n_a + n_b;
    for (int k0 = 0; k0 < n; k0 += kMergeBatch) {
      float ms[kMergeBatch], ls[kMergeBatch], va[kMergeBatch][8];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int k = k0 + j;
        if (k >= n) break;
        const int64_t ps_ = part + static_cast<int64_t>(k < n_a ? k : k + b0) * G;
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
        l += ls[j] * w;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += w * va[j][i];
      }
    }
    if (p.include_current) {
      const float pc = expf(cur - m);
      l += pc;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (lane + 32 * i < hd) acc[i] += pc * p.v_cur[cur_base + lane + 32 * i];
    }
    const float den = l > 0.f ? l : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < hd) p.out[row + lane + 32 * i] = acc[i] / den;
  }
}

template <int PT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (p.splits > 0) {
    const int G = p.H / p.Hkv;
    const size_t smem = sizeof(float) * (static_cast<size_t>(G) * (p.hd + p.chunk) +
                                         static_cast<size_t>(kWarps) * kPV * p.hd);
    auto kernel = split_kernel<PT>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<dim3(p.splits, p.Hkv, B), kThreads, smem, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  merge_kernel<<<B, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a cudaError_t code.
// Segment B is absent when b_lengths is null; k_cur/v_cur are read only
// when include_current != 0; the scale pointers only for int8 pages
// (page_type: 0 bf16, 1 int8, 2 float8 e4m3). chunk and splits are the
// host's plan (ops/fused_attn.py::split_plan); part_acc, part_m and part_l
// are its workspaces, [B, Hkv, splits, G, hd] and [B, Hkv, splits, G] f32.
extern "C" int t5g_batch_paged_attention(
    const float* q, const float* k_cur, const float* v_cur,
    const void* a_k, const void* a_v, const float* a_ks, const float* a_vs,
    const int* a_lengths, const int* a_pages, int a_pages_per_row, int64_t a_num_pages,
    const void* b_k, const void* b_v, const float* b_ks, const float* b_vs,
    const int* b_lengths, const int* b_pages, int b_pages_per_row, int64_t b_num_pages,
    float* out, float* part_acc, float* part_m, float* part_l, int chunk, int splits,
    int B, int H, int Hkv, int hd, int ps,
    float soft_cap, int include_current, int page_type, void* stream) {
  if (b_lengths == nullptr) b_pages_per_row = 0;
  if (hd % 8 || hd > 256 || H % Hkv || chunk <= 0 || ps % chunk ||
      static_cast<int64_t>(splits) * chunk !=
          static_cast<int64_t>(a_pages_per_row + b_pages_per_row) * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k_cur = k_cur;
  p.v_cur = v_cur;
  p.seg[0] = Segment{a_k, a_v, a_ks, a_vs, a_lengths, a_pages, a_pages_per_row, a_num_pages};
  p.seg[1] = Segment{b_k, b_v, b_ks, b_vs, b_lengths, b_pages, b_pages_per_row, b_num_pages};
  p.out = out;
  p.part_acc = part_acc;
  p.part_m = part_m;
  p.part_l = part_l;
  p.H = H;
  p.Hkv = Hkv;
  p.hd = hd;
  p.ps = ps;
  p.soft_cap = soft_cap;
  p.include_current = include_current;
  p.chunk = chunk;
  p.splits = splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_type) {
    case kBf16: return static_cast<int>(launch<kBf16>(p, B, s));
    case kInt8: return static_cast<int>(launch<kInt8>(p, B, s));
    case kE4m3: return static_cast<int>(launch<kE4m3>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
