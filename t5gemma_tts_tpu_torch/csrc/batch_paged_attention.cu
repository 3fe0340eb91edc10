// Two-segment paged decode attention for Hopper (sm_90a).
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
// nothing assumes identity paging.
//
// Bound: the bytes of the K/V pages (and scales) that it reads. Each page
// element is read from device memory exactly once per (row, kv head): the
// logits pass streams K rows one 8-element chunk per lane (16 bytes of
// bf16, 8 of int8 or e4m3; neighbouring lanes on neighbouring addresses)
// and the P.V pass streams V rows with neighbouring threads on neighbouring
// elements. The
// G = H / Hkv queries of a kv head share one CTA, so a page is read once for
// all of them, and every reduction (max, sum, accumulator) stays in
// registers and shared memory. This first design uses one CTA per
// (row, kv head) and does not split a row's pages across CTAs: at small
// batch it fills few of the 132 SMs (see PERF.md).

#include "paged_pages.cuh"

namespace {

using namespace t5g_pages;

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // queries handled together in registers

struct Segment {
  const void* k;        // [Hkv, NP, ps, hd] bf16 or int8
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
  int H, Hkv, hd, ps;
  float soft_cap;       // <= 0: no cap
  int include_current;
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
__global__ void __launch_bounds__(kThreads)
batch_paged_attention_kernel(const Params p) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int hd = p.hd;
  const int ps = p.ps;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nchunks = hd / 8;

  extern __shared__ float smem[];
  float* q_s = smem;               // [G, hd]
  float* acc_s = q_s + G * hd;     // [G, hd]
  float* s_s = acc_s + G * hd;     // [G, ps] logits, then probabilities
  float* m_s = s_s + G * ps;       // [G] running max
  float* l_s = m_s + G;            // [G] running sum
  float* a_s = l_s + G;            // [G] rescale of this block

  const int64_t q_base = (static_cast<int64_t>(b) * p.H + kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = p.q[q_base + i];
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kMaskValue;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int si = 0; si < 2; ++si) {
    const Segment& S = p.seg[si];
    if (S.lengths == nullptr) continue;
    int len = S.lengths[b];
    if (si == 0) len = max(len, 1);  // segment A is clamped to >= 1
    const int npages = min((len + ps - 1) / ps, S.pages_per_row);
    for (int i = 0; i < npages; ++i) {
      const int pid = S.pages[static_cast<int64_t>(b) * S.pages_per_row + i];
      const int64_t row0 = (static_cast<int64_t>(kvh) * S.num_pages + pid) * ps;
      const int nvalid = min(ps, len - i * ps);

      // logits: one warp per token, one 8-element chunk of hd per lane
      for (int t = warp; t < nvalid; t += kWarps) {
        float kv[8];
        const bool active = lane < nchunks;
        if (active) {
          load8<PT>(S.k, (row0 + t) * hd + lane * 8, kv);
          if constexpr (PT == kInt8) {
            const float sc = S.k_scale[row0 + t];
#pragma unroll
            for (int j = 0; j < 8; ++j) kv[j] *= sc;
          }
        }
        for (int g0 = 0; g0 < G; g0 += kGroup) {
          float part[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            part[j] = 0.f;
            if (active && g0 + j < G) {
              const float* qg = q_s + (g0 + j) * hd + lane * 8;
#pragma unroll
              for (int e = 0; e < 8; ++e) part[j] += qg[e] * kv[e];
            }
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float x = warp_sum(part[j]);
            if (lane == 0 && g0 + j < G) s_s[(g0 + j) * ps + t] = cap(x, p.soft_cap);
          }
        }
      }
      __syncthreads();

      // online softmax update: one warp per query
      for (int g = warp; g < G; g += kWarps) {
        float* sg = s_s + g * ps;
        float mx = kMaskValue;
        for (int t = lane; t < nvalid; t += 32) mx = fmaxf(mx, sg[t]);
        mx = warp_max(mx);
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < ps; t += 32) {
          const float e = t < nvalid ? expf(sg[t] - m_new) : 0.f;
          sg[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P . V: each thread owns output dims d
      for (int d = tid; d < hd; d += kThreads) {
        for (int g0 = 0; g0 < G; g0 += kGroup) {
          float r[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            r[j] = g0 + j < G ? acc_s[(g0 + j) * hd + d] * a_s[g0 + j] : 0.f;
          for (int t = 0; t < nvalid; ++t) {
            float v = load1<PT>(S.v, (row0 + t) * hd + d);
            if constexpr (PT == kInt8) v *= S.v_scale[row0 + t];
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              if (g0 + j < G) r[j] += s_s[(g0 + j) * ps + t] * v;
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (g0 + j < G) acc_s[(g0 + j) * hd + d] = r[j];
        }
      }
      __syncthreads();
    }
  }

  if (p.include_current) {
    // the in-flight token is always valid and joins the statistics last
    const int64_t cur_base = (static_cast<int64_t>(b) * p.Hkv + kvh) * hd;
    for (int g = warp; g < G; g += kWarps) {
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[g * hd + d] * p.k_cur[cur_base + d];
      const float cur = cap(warp_sum(part), p.soft_cap);
      if (lane == 0) {
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, cur);
        const float pc = expf(cur - m_new);
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + pc;
        m_s[g] = m_new;
        a_s[g] = alpha;
        s_s[g * ps] = pc;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      acc_s[i] = acc_s[i] * a_s[g] + s_s[g * ps] * p.v_cur[cur_base + (i - g * hd)];
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const float l = l_s[i / hd];
    p.out[q_base + i] = acc_s[i] / (l > 0.f ? l : 1.f);
  }
}

template <int PT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(2 * G * p.hd) + static_cast<size_t>(G) * p.ps + 3 * G);
  auto kernel = batch_paged_attention_kernel<PT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(B, p.Hkv), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a cudaError_t code.
// Segment B is absent when b_lengths is null; k_cur/v_cur are read only
// when include_current != 0; the scale pointers only for int8 pages
// (page_type: 0 bf16, 1 int8, 2 float8 e4m3).
extern "C" int t5g_batch_paged_attention(
    const float* q, const float* k_cur, const float* v_cur,
    const void* a_k, const void* a_v, const float* a_ks, const float* a_vs,
    const int* a_lengths, const int* a_pages, int a_pages_per_row, int64_t a_num_pages,
    const void* b_k, const void* b_v, const float* b_ks, const float* b_vs,
    const int* b_lengths, const int* b_pages, int b_pages_per_row, int64_t b_num_pages,
    float* out, int B, int H, int Hkv, int hd, int ps,
    float soft_cap, int include_current, int page_type, void* stream) {
  Params p;
  p.q = q;
  p.k_cur = k_cur;
  p.v_cur = v_cur;
  p.seg[0] = Segment{a_k, a_v, a_ks, a_vs, a_lengths, a_pages, a_pages_per_row, a_num_pages};
  p.seg[1] = Segment{b_k, b_v, b_ks, b_vs, b_lengths, b_pages, b_pages_per_row, b_num_pages};
  p.out = out;
  p.H = H;
  p.Hkv = Hkv;
  p.hd = hd;
  p.ps = ps;
  p.soft_cap = soft_cap;
  p.include_current = include_current;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_type) {
    case kBf16: return static_cast<int>(launch<kBf16>(p, B, s));
    case kInt8: return static_cast<int>(launch<kInt8>(p, B, s));
    case kE4m3: return static_cast<int>(launch<kE4m3>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
