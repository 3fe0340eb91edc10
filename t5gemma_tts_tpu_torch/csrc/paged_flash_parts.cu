// One-segment paged decode attention with flash statistics, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/paged_attn.py::
// _paged_attention_ml_call (the upstream Pallas
// paged_flash_attention_kernel_inline_seq_dim, reached through
// paged_flash_parts, and through the upstream paged_attention entry by
// paged_gqa_attention). For each row b of B' rows (the speculative verify
// pass sends B * S pseudo-rows, S chain positions of each cache row, all
// with the row's page table and length) and each query head it computes
// flash attention over the row's valid pages of ONE segment and writes
//
//   out [B', H, hd]  the normalized f32 output  acc / (l > 0 ? l : 1)
//   m   [B', H]      the running max of the logits
//   l   [B', H]      the running sum of exp(logit - m)
//
// so that segments and in-flight tokens compose exactly through the flash
// merges (ops/paged_attn.py). Logits are f32: q (roped, pre-scaled) . k,
// then tanh(logits / cap) * cap BEFORE the length mask. Pages are
// [Hkv, NP, ps, hd], bf16 or float8 e4m3, widened exactly to f32; page ids
// come from page_indices[b, i].
//
// Empty rows. Tokens past a row's length are never read, and m starts at
// -inf, so a row of length 0 gives (0, -inf, 0), as the plain version does.
// The TPU kernel masks with -0.7 * FLT_MAX instead and leaves m at that
// value and l at 0 for such a row. The merges weigh a part by
// l * exp(m - m_new) and zero it where m is not finite, so either form
// contributes 0: the merged result is the same.
//
// Bound: the bytes of the valid K/V pages. A CTA per (row, kv head) reads
// each valid page element once for the G = H / Hkv queries of that kv head
// (K with one 8-element chunk per lane: 16 bytes of bf16, 8 of e4m3; V with
// neighbouring threads on neighbouring elements), and every reduction stays
// in registers and shared memory. The S pseudo-rows of one cache row read
// the same pages S times: S times the byte bound of one row, which the
// chip smoke run reports (the repeats mostly hit L2). Sharing one page
// read across the chain, and splitting a long row over several CTAs, are
// later work.

#include "paged_pages.cuh"

namespace {

using namespace t5g_pages;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // queries handled together in registers

struct Params {
  const float* q;       // [B, H, hd]
  const void* k;        // [Hkv, NP, ps, hd]
  const void* v;
  const int* lengths;   // [B]
  const int* pages;     // [B, pages_per_row]
  int pages_per_row;
  int64_t num_pages;    // NP
  float* out;           // [B, H, hd]
  float* m;             // [B, H]
  float* l;             // [B, H]
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
paged_flash_parts_kernel(const Params p) {
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
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = p.lengths[b];
  const int npages = min((max(len, 0) + ps - 1) / ps, p.pages_per_row);
  for (int i = 0; i < npages; ++i) {
    const int pid = p.pages[static_cast<int64_t>(b) * p.pages_per_row + i];
    const int64_t row0 = (static_cast<int64_t>(kvh) * p.num_pages + pid) * ps;
    const int nvalid = min(ps, len - i * ps);

    // logits: one warp per token, one 8-element chunk of hd per lane
    for (int t = warp; t < nvalid; t += kWarps) {
      float kv[8];
      const bool active = lane < nchunks;
      if (active) load8<PT>(p.k, (row0 + t) * hd + lane * 8, kv);
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

    // online softmax update: one warp per query (the block has >= 1 valid
    // token, so m_new is finite and exp(-inf - m_new) = 0 rescales nothing)
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * ps;
      float mx = -INFINITY;
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
          const float v = load1<PT>(p.v, (row0 + t) * hd + d);
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

  for (int i = tid; i < G * hd; i += kThreads) {
    const float l = l_s[i / hd];
    p.out[q_base + i] = acc_s[i] / (l > 0.f ? l : 1.f);
  }
  const int64_t ml_base = static_cast<int64_t>(b) * p.H + kvh * G;
  for (int g = tid; g < G; g += kThreads) {
    p.m[ml_base + g] = m_s[g];
    p.l[ml_base + g] = l_s[g];
  }
}

template <int PT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(2 * G * p.hd) + static_cast<size_t>(G) * p.ps + 3 * G);
  auto kernel = paged_flash_parts_kernel<PT>;
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
extern "C" int t5g_paged_flash_parts(
    const float* q, const void* k, const void* v, const int* lengths, const int* pages,
    int pages_per_row, int64_t num_pages, float* out, float* m, float* l,
    int B, int H, int Hkv, int hd, int ps, float soft_cap, int page_type, void* stream) {
  if (hd % 8 || hd > 256 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, lengths, pages, pages_per_row, num_pages, out, m, l,
                 H, Hkv, hd, ps, soft_cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_type) {
    case kBf16: return static_cast<int>(launch<kBf16>(p, B, s));
    case kE4m3: return static_cast<int>(launch<kE4m3>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
