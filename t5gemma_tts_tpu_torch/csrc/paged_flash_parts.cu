// One-segment paged decode attention with flash statistics, for Hopper
// (sm_90a), split-KV.
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/paged_attn.py::
// _paged_attention_ml_call (the upstream Pallas
// paged_flash_attention_kernel_inline_seq_dim, reached through
// paged_flash_parts, and through the upstream paged_attention entry by
// paged_gqa_attention). For each of B * chain pseudo-rows and each query
// head it computes flash attention over the valid pages of ONE segment of
// the pseudo-row's cache row and writes
//
//   out [B * chain, H, hd]  the normalized f32 output  acc / (l > 0 ? l : 1)
//   m   [B * chain, H]      the largest logit (-inf for an empty row)
//   l   [B * chain, H]      the sum of exp(logit - m)
//
// so that segments and in-flight tokens compose exactly through the flash
// merges (ops/paged_attn.py). Logits are f32: q (roped, pre-scaled) . k,
// then tanh(logits / cap) * cap BEFORE the length mask. Pages are
// [Hkv, NP, ps, hd], bf16 or float8 e4m3, widened exactly to f32; page ids
// come from page_indices[b, i], any table.
//
// Chain. The speculative verify pass sends S = chain positions of each of
// B cache rows, chain-position-major within a row (pseudo-row b * chain + s
// is position s of cache row b). All positions of a row see the row's one
// length and page table, so lengths and page_indices hold one entry per
// cache row (chain = 1 is the plain decode step).
//
// Empty rows. Tokens past a row's length are never read, so a row of length
// 0 gives (0, -inf, 0), as the plain version does. The TPU kernel masks
// with -0.7 * FLT_MAX instead and leaves m at that value and l at 0 for such
// a row. The merges weigh a part by l * exp(m - m_new) and zero it where m
// is not finite, so either form contributes 0: the merged result is the
// same.
//
// Bound: the bytes of the valid K/V pages of each cache row, once. At decode
// sizes B x Hkv (cache row, kv head) pairs are 4-16 CTAs on a card of 132
// SMs, so the design is split-KV:
//
//   split_kernel  one CTA per (split, kv head, cache row). The host's plan
//                 (ops/fused_attn.py::split_plan) cuts the capacity
//                 (pages_per_row * ps tokens, never the lengths: the launch
//                 needs no host sync and a CUDA graph captures it) into
//                 chunks of `chunk` tokens, a divisor of the page, as many
//                 as make B x Hkv x splits fill a wave. The CTA serves all
//                 chain x G queries of its cache row and kv head, so each
//                 K/V byte leaves device memory once per call, not once per
//                 chain position. It copies the chunk's V rows into shared
//                 memory with cp.async (contiguous: a chunk never straddles
//                 a page) while it computes the logits (a warp per token, a
//                 lane per 8-element slice of hd: one 16-byte load of bf16,
//                 8 of e4m3, K kept in registers, kBatch tokens' loads
//                 issued first), then the chunk's max and exp sums (a warp
//                 per query), then P.V from shared memory (a thread per
//                 query and 8 output dims, tokens in order: no sum across
//                 warps). It writes the unnormalized partial (acc, m, l); a
//                 chunk past the row's length writes the neutral
//                 (0, -inf, 0).
//   merge_kernel  one CTA per pseudo-row, a warp per query head: the
//                 partials of the splits that hold the row's tokens, in
//                 split order (the rest are never read), m = the largest
//                 partial max, l = sum l_k exp(m_k - m), out = acc / l.

#include "paged_pages.cuh"

namespace {

using namespace t5g_pages;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;        // logits: queries per register group
constexpr int kBatch = 4;        // tokens a warp loads before it computes
constexpr int kMergeBatch = 8;   // splits a merge warp loads before it sums

struct Params {
  const float* q;       // [B * chain, H, hd]
  const void* k;        // [Hkv, NP, ps, hd]
  const void* v;
  const int* lengths;   // [B]
  const int* pages;     // [B, pages_per_row]
  int pages_per_row;
  int64_t num_pages;    // NP
  float* out;           // [B * chain, H, hd]
  float* m;             // [B * chain, H]
  float* l;             // [B * chain, H]
  float* part_acc;      // [B, Hkv, splits, chain * G, hd] unnormalized partials
  float* part_m;        // [B, Hkv, splits, chain * G]
  float* part_l;
  int chain, H, Hkv, hd, ps;
  int chunk, splits;    // the host's plan: splits * chunk = pages_per_row * ps
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

// the row's valid tokens, at most its capacity
__device__ __forceinline__ int row_len(const Params& p, int b) {
  return min(max(p.lengths[b], 0), p.pages_per_row * p.ps);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes)
                 : "memory");
  }
}

template <int PT>
__host__ __device__ constexpr int elem_bytes() {
  return PT == kBf16 ? 2 : 1;
}

// shared memory of a split CTA: V rows [chunk, hd] as stored, then q
// [Q, hd] and the chunk's logits [Q, chunk] in f32
template <int PT>
__host__ __device__ inline size_t v_bytes(int chunk, int hd) {
  return (static_cast<size_t>(chunk) * hd * elem_bytes<PT>() + 15) / 16 * 16;
}

template <int PT>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Params p) {
  constexpr int E = elem_bytes<PT>();
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int Q = p.chain * G;          // queries of this CTA: j = s * G + g
  const int hd = p.hd;
  const int chunk = p.chunk;
  const int slices = hd / 8;          // 8-element slices of a row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int tok = split * chunk;
  const int n = min(chunk, row_len(p, b) - tok);   // valid tokens of this chunk
  const int64_t part = (static_cast<int64_t>(b * p.Hkv + kvh) * p.splits + split) * Q;
  if (n <= 0) {                       // past the row's length: neutral partial
    float4* acc = reinterpret_cast<float4*>(p.part_acc + part * hd);
    for (int i = tid; i < Q * hd / 4; i += kThreads) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = tid; j < Q; j += kThreads) {
      p.part_m[part + j] = -INFINITY;
      p.part_l[part + j] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* v_s = smem;                                      // [chunk, hd]
  float* q_s = reinterpret_cast<float*>(smem + v_bytes<PT>(chunk, hd));  // [Q, hd]
  float* s_s = q_s + Q * hd;          // [Q, chunk] logits, then probabilities

  const int pid = p.pages[static_cast<int64_t>(b) * p.pages_per_row + tok / p.ps];
  const int64_t row0 = (static_cast<int64_t>(kvh) * p.num_pages + pid) * p.ps + tok % p.ps;

  // the chunk's V rows land in shared memory while the logits are computed
  const unsigned char* v_src = static_cast<const unsigned char*>(p.v) + row0 * hd * E;
  for (int i = tid; i < n * slices; i += kThreads)
    cp_async<8 * E>(v_s + i * 8 * E, v_src + i * 8 * E);

  // q: query j = s * G + g is head kvh * G + g of pseudo-row b * chain + s
  const int q4 = hd / 4;
  for (int i = tid; i < Q * q4; i += kThreads) {
    const int j = i / q4;
    const int c = i - j * q4;
    const int s = j / G;
    const int64_t src = ((static_cast<int64_t>(b) * p.chain + s) * p.H + kvh * G + (j - s * G)) * hd;
    reinterpret_cast<float4*>(q_s + j * hd)[c] = reinterpret_cast<const float4*>(p.q + src)[c];
  }
  __syncthreads();

  // logits: a warp per token, kBatch tokens' K slices loaded first
  const bool active = lane < slices;
  for (int t0 = warp; t0 < n; t0 += kWarps * kBatch) {
    float kv[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kWarps;
      if (active && t < n) load8<PT>(p.k, (row0 + t) * hd + lane * 8, kv[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kWarps;
      if (t >= n) break;
      for (int j0 = 0; j0 < Q; j0 += kGroup) {
        float d[kGroup];
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          d[jj] = 0.f;
          if (active && j0 + jj < Q) {
            const float* qj = q_s + (j0 + jj) * hd + lane * 8;
#pragma unroll
            for (int e = 0; e < 8; ++e) d[jj] += qj[e] * kv[u][e];
          }
        }
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          if (j0 + jj >= Q) break;
          const float x = warp_sum(d[jj]);
          if (lane == 0) s_s[(j0 + jj) * chunk + t] = cap(x, p.soft_cap);
        }
      }
    }
  }
  __syncthreads();

  // the chunk's softmax statistics: a warp per query
  for (int j = warp; j < Q; j += kWarps) {
    float* sj = s_s + j * chunk;
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sj[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(sj[t] - mx);
      sj[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      p.part_m[part + j] = mx;
      p.part_l[part + j] = sum;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // P.V from shared memory: a thread per (query, 8-element slice), the
  // chunk's tokens in order
  const int per_round = kThreads / slices;     // queries a round
  const int jt = tid / slices;
  const int c = tid - jt * slices;
  if (jt >= per_round) return;
  for (int j = jt; j < Q; j += per_round) {
    const float* pj = s_s + j * chunk;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int t = 0; t < n; ++t) {
      float vv[8];
      load8<PT>(v_s, static_cast<int64_t>(t) * hd + c * 8, vv);
      const float pt = pj[t];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += pt * vv[e];
    }
    float4* dst = reinterpret_cast<float4*>(p.part_acc + (part + j) * hd + c * 8);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// One CTA per pseudo-row, a warp per query head: the live partials in split
// order, then acc / l.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const Params p) {
  const int r = blockIdx.x;
  const int b = r / p.chain;
  const int s = r - b * p.chain;
  const int G = p.H / p.Hkv;
  const int Q = p.chain * G;
  const int hd = p.hd;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the splits that hold the row's tokens: k < n
  const int n = (row_len(p, b) + p.chunk - 1) / p.chunk;
  for (int hh = warp; hh < p.H; hh += kWarps) {
    const int kvh = hh / G;
    const int64_t base =
        static_cast<int64_t>(b * p.Hkv + kvh) * p.splits * Q + s * G + (hh - kvh * G);
    float m = -INFINITY;
    for (int k = lane; k < n; k += 32) m = fmaxf(m, p.part_m[base + static_cast<int64_t>(k) * Q]);
    m = warp_max(m);
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    float l = 0.f;
    // kMergeBatch splits' partials loaded before any is summed, then summed
    // in split order
    for (int k0 = 0; k0 < n; k0 += kMergeBatch) {
      float ms[kMergeBatch], ls[kMergeBatch], va[kMergeBatch][8];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        if (k0 + j >= n) break;
        const int64_t idx = base + static_cast<int64_t>(k0 + j) * Q;
        ms[j] = p.part_m[idx];
        ls[j] = p.part_l[idx];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          va[j][i] = lane + 32 * i < hd ? p.part_acc[idx * hd + lane + 32 * i] : 0.f;
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
    const int64_t row = static_cast<int64_t>(r) * p.H + hh;
    const float den = l > 0.f ? l : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < hd) p.out[row * hd + lane + 32 * i] = acc[i] / den;
    if (lane == 0) {
      p.m[row] = m;
      p.l[row] = l;
    }
  }
}

template <int PT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (p.splits > 0) {
    const int Q = p.chain * (p.H / p.Hkv);
    const size_t smem = v_bytes<PT>(p.chunk, p.hd) +
                        sizeof(float) * static_cast<size_t>(Q) * (p.hd + p.chunk);
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
  merge_kernel<<<B * p.chain, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a cudaError_t code.
// page_type: 0 bf16, 2 float8 e4m3 (the PageType of paged_pages.cuh). B is
// the number of cache rows; q, out, m and l hold B * chain pseudo-rows.
extern "C" int t5g_paged_flash_parts(
    const float* q, const void* k, const void* v, const int* lengths, const int* pages,
    int pages_per_row, int64_t num_pages, float* out, float* m, float* l, float* part_acc,
    float* part_m, float* part_l, int B, int chain, int H, int Hkv, int hd, int ps, int chunk,
    int splits, float soft_cap, int page_type, void* stream) {
  if (hd % 8 || hd > 256 || H % Hkv || chain < 1 || chunk < 1 || ps % chunk ||
      static_cast<int64_t>(splits) * chunk != static_cast<int64_t>(pages_per_row) * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, lengths, pages, pages_per_row, num_pages, out, m, l,
                 part_acc, part_m, part_l, chain, H, Hkv, hd, ps, chunk, splits, soft_cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_type) {
    case kBf16: return static_cast<int>(launch<kBf16>(p, B, s));
    case kE4m3: return static_cast<int>(launch<kE4m3>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
