// Two-segment paged decode attention for Hopper (sm_90a), split over CTAs:
// the C entry point.
//
// Replaces the TPU kernel t5gemma_tts_tpu/ops/fused_attn.py::_batch_kernel
// (reached through batch_paged_attention). Segment A's length is clamped to
// >= 1 (kClampA = true); the in-flight token joins when include_current.
// The split and merge kernels, their function, bound and design are in
// split_attention.cuh, which the v1 kernel (fused_decode_attention.cu)
// instantiates with kClampA = false.

#include "split_attention.cuh"

using namespace t5g_pages;
using namespace t5g_split;

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
    case kBf16: return static_cast<int>(launch<kBf16, true>(p, B, s));
    case kInt8: return static_cast<int>(launch<kInt8, true>(p, B, s));
    case kE4m3: return static_cast<int>(launch<kE4m3, true>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
