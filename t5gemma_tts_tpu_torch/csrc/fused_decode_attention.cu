// Fused decode self-attention over prompt pages, generation pages and the
// in-flight token, for Hopper (sm_90a).
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/fused_attn.py::_kernel (the
// v1 per-(row, kv head) grid, reached through fused_decode_attention; the
// decode step's attention mode 1, T5G_FUSED_ATTN=1). For each batch row b
// and kv head it runs one flash pass over the row's valid prompt pages,
// then its valid generation pages, then the in-flight token, and writes the
// normalized f32 output of the G = H / Hkv query heads of that kv head:
//
//   logits = q . k            (q arrives roped and pre-scaled, f32)
//   logits = tanh(logits / cap) * cap        (soft cap BEFORE the mask)
//   out = acc / l             (l > 0: the in-flight token is always valid)
//
// Pages are [Hkv, NP, ps, hd], bf16 or float8 e4m3, widened exactly to f32;
// everything else stays f32 (q, p, the accumulator; nothing is rounded to
// bf16). Page ids come from page_indices[b, i] and may address a buffer
// that holds every layer's pages. Where it differs from the two-segment
// kernel (batch_paged_attention.cu, mode 2): a prompt segment of length 0
// reads no page (that kernel clamps segment A to >= 1); the in-flight token
// is always there; int8 pages are refused (the selector never sends them).
// The running max starts at the TPU kernel's mask value -0.7 * FLT_MAX and
// tokens past a segment's length are never read, which gives the TPU
// kernel's statistics exactly: there a masked column's probability is 0 and
// its logit never raises the max.
//
// The page steps are batch_paged_attention.cu's, written out again here:
// moving the paged kernels' page steps into one shared device function
// compiled to other register allocations and made the two-segment and
// one-segment kernels 32-43 % slower on the card.
//
// Bound: the bytes of the valid K/V pages. A CTA per (row, kv head), as the
// TPU grid (b, hkv), reads each valid page element once for its G queries
// (K with one 8-element chunk per lane: 16 bytes of bf16, 8 of e4m3; V with
// neighbouring threads on neighbouring elements); the softmax statistics
// and the accumulator stay in shared memory, and no page is staged (one
// bf16 page of K and V at hd 256 would take 128 KB). At batch B it fills
// B * Hkv of the 132 SMs; splitting a row's pages over CTAs is later work.

#include "paged_pages.cuh"

namespace {

using namespace t5g_pages;

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // queries handled together in registers

struct Segment {
  const void* k;        // [Hkv, NP, ps, hd]
  const void* v;
  const int* lengths;   // [B]
  const int* pages;     // [B, pages_per_row]
  int pages_per_row;
  int64_t num_pages;    // NP
};

struct Params {
  const float* q;       // [B, H, hd]
  const float* k_cur;   // [B, Hkv, hd]
  const float* v_cur;
  Segment seg[2];       // prompt, generation
  float* out;           // [B, H, hd]
  int H, Hkv, hd, ps;
  float soft_cap;       // <= 0: no cap
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
fused_decode_attention_kernel(const Params p) {
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
  float* a_s = l_s + G;            // [G] rescale of this page

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
    const int len = max(S.lengths[b], 0);   // no clamp: 0 reads no page
    const int npages = min((len + ps - 1) / ps, S.pages_per_row);
    for (int i = 0; i < npages; ++i) {
      const int pid = S.pages[static_cast<int64_t>(b) * S.pages_per_row + i];
      const int64_t row0 = (static_cast<int64_t>(kvh) * S.num_pages + pid) * ps;
      const int nvalid = min(ps, len - i * ps);

      // logits: one warp per token, one 8-element chunk of hd per lane
      for (int t = warp; t < nvalid; t += kWarps) {
        float kv[8];
        const bool active = lane < nchunks;
        if (active) load8<PT>(S.k, (row0 + t) * hd + lane * 8, kv);
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
            const float v = load1<PT>(S.v, (row0 + t) * hd + d);
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

  // the in-flight token: always valid, joins the statistics last
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
      a_s[g] = alpha;
      s_s[g * ps] = pc;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    const float acc = acc_s[i] * a_s[g] + s_s[g * ps] * p.v_cur[cur_base + (i - g * hd)];
    p.out[q_base + i] = acc / l_s[g];
  }
}

template <int PT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(2 * G * p.hd) + static_cast<size_t>(G) * p.ps + 3 * G);
  auto kernel = fused_decode_attention_kernel<PT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  if (B == 0) return cudaSuccess;
  kernel<<<dim3(B, p.Hkv), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a cudaError_t code.
// page_type: 0 bf16, 2 float8 e4m3 (the PageType of paged_pages.cuh).
extern "C" int t5g_fused_decode_attention(
    const float* q, const float* k_cur, const float* v_cur,
    const void* p_k, const void* p_v, const int* p_lengths, const int* p_pages,
    int p_pages_per_row, int64_t p_num_pages,
    const void* g_k, const void* g_v, const int* g_lengths, const int* g_pages,
    int g_pages_per_row, int64_t g_num_pages,
    float* out, int B, int H, int Hkv, int hd, int ps, float soft_cap, int page_type,
    void* stream) {
  if (hd % 8 || hd > 256 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k_cur = k_cur;
  p.v_cur = v_cur;
  p.seg[0] = Segment{p_k, p_v, p_lengths, p_pages, p_pages_per_row, p_num_pages};
  p.seg[1] = Segment{g_k, g_v, g_lengths, g_pages, g_pages_per_row, g_num_pages};
  p.out = out;
  p.H = H;
  p.Hkv = Hkv;
  p.hd = hd;
  p.ps = ps;
  p.soft_cap = soft_cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_type) {
    case kBf16: return static_cast<int>(launch<kBf16>(p, B, s));
    case kE4m3: return static_cast<int>(launch<kE4m3>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
