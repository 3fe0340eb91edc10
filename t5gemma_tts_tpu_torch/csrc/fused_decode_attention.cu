// Fused decode self-attention over prompt pages, generation pages and the
// in-flight token, for Hopper (sm_90a): the C entry point.
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/fused_attn.py::_kernel (the
// v1 per-(row, kv head) grid, reached through fused_decode_attention; the
// decode step's attention mode 1, T5G_FUSED_ATTN=1). For each batch row b
// and query head it computes flash attention over the row's valid prompt
// tokens, then its valid generation tokens, then the in-flight token:
//
//   logits = q . k            (q arrives roped and pre-scaled, f32)
//   logits = tanh(logits / cap) * cap        (soft cap BEFORE the mask)
//   out = acc / l             (l > 0: the in-flight token is always valid)
//
// Pages are [Hkv, NP, ps, hd], bf16 or float8 e4m3, widened exactly to f32;
// everything else stays f32 (q, p, the accumulator; nothing is rounded to
// bf16). Page ids come from page_indices[b, i] and may address a buffer
// that holds every layer's pages.
//
// This is the two-segment kernel's split-KV design (split_attention.cuh:
// a split kernel over the host's plan of both segments' capacity, one CTA
// per (split, kv head, row), and a merge kernel, one CTA per row), with
// the prompt as segment A and the generation as segment B, instantiated
// for the four ways in which v1 differs from the two-segment kernel:
//
//   1. a prompt segment of length 0 reads no page (kClampA = false; the
//      two-segment kernel clamps segment A to >= 1);
//   2. the in-flight token is always there (include_current = 1);
//   3. int8 pages are refused (the selector never sends them);
//   4. the output acc / l: l > 0 always, so the two-segment kernel's
//      acc / (l > 0 ? l : 1) is the same function.
//
// The running max starts at the TPU kernel's mask value -0.7 * FLT_MAX and
// tokens past a segment's length are never read, which gives the TPU
// kernel's statistics: there a masked column's probability is 0 and its
// logit never raises the max.

#include "split_attention.cuh"

using namespace t5g_pages;
using namespace t5g_split;

// Plain C entry point (bound with ctypes). Returns a cudaError_t code.
// page_type: 0 bf16, 2 float8 e4m3 (the PageType of paged_pages.cuh).
// chunk and splits are the host's plan (ops/fused_attn.py::split_plan over
// both segments' capacity); part_acc, part_m and part_l are its workspaces,
// [B, Hkv, splits, G, hd] and [B, Hkv, splits, G] f32.
extern "C" int t5g_fused_decode_attention(
    const float* q, const float* k_cur, const float* v_cur,
    const void* p_k, const void* p_v, const int* p_lengths, const int* p_pages,
    int p_pages_per_row, int64_t p_num_pages,
    const void* g_k, const void* g_v, const int* g_lengths, const int* g_pages,
    int g_pages_per_row, int64_t g_num_pages,
    float* out, float* part_acc, float* part_m, float* part_l, int chunk, int splits,
    int B, int H, int Hkv, int hd, int ps, float soft_cap, int page_type, void* stream) {
  if (hd % 8 || hd > 256 || H % Hkv || chunk <= 0 || ps % chunk ||
      static_cast<int64_t>(splits) * chunk !=
          static_cast<int64_t>(p_pages_per_row + g_pages_per_row) * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k_cur = k_cur;
  p.v_cur = v_cur;
  p.seg[0] = Segment{p_k, p_v, nullptr, nullptr, p_lengths, p_pages, p_pages_per_row,
                     p_num_pages};
  p.seg[1] = Segment{g_k, g_v, nullptr, nullptr, g_lengths, g_pages, g_pages_per_row,
                     g_num_pages};
  p.out = out;
  p.part_acc = part_acc;
  p.part_m = part_m;
  p.part_l = part_l;
  p.H = H;
  p.Hkv = Hkv;
  p.hd = hd;
  p.ps = ps;
  p.soft_cap = soft_cap;
  p.include_current = 1;
  p.chunk = chunk;
  p.splits = splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_type) {
    case kBf16: return static_cast<int>(launch<kBf16, false>(p, B, s));
    case kE4m3: return static_cast<int>(launch<kE4m3, false>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
