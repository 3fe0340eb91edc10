"""k1_roofline.arrivals: kernel 1 (``ops/fused_attn.py::
batch_paged_attention`` -> ``csrc/batch_paged_attention.cu``, the split
and merge kernels of ``csrc/split_attention.cuh``) over the traced
stretch: the least time of its calls over their device time.

Each step body calls it twice a layer: self-attention over a row's prompt
pages (BOS and prompt), its generated tokens so far and the in-flight
token, and cross-attention over its text's pages. The bound counts the
rows that the segment advanced, at their own lengths, for the bodies that
advanced them (``harness/costs.attention_bytes_ops``: the valid K/V, the
page-table entries, the lengths, q and the f32 output); a row that is idle
or done is work the inputs do not need."""

from benchmark.harness import costs

KERNELS = r"t5g_split::(?:split|merge)_kernel"


def read(facts, trace):
    segs = facts.get("traced_segments")
    if not segs or trace is None:
        return None
    t = trace.time_s(KERNELS)
    if not t:
        return None
    c = facts["config"]
    w = costs.widths_of(c)
    layers = int(c["num_decoder_layers"])
    elem, scales = facts["kv_elem"], facts["kv_scales"]
    bound = 0.0
    for s in segs:
        for b in range(s["bodies"]):
            live = [(plen, g0 + b, xlen) for plen, g0, adv, xlen in s["rows"]
                    if b < adv]
            if not live:
                continue
            sb, so = costs.attention_bytes_ops(
                w, [(p, g) for p, g, _ in live], elem, scales, True)
            cb, co = costs.attention_bytes_ops(
                w, [(x,) for _, _, x in live], elem, scales, False)
            bound += layers * (costs.bound_s(sb, so, costs.PEAK_F32_FLOPS)
                               + costs.bound_s(cb, co, costs.PEAK_F32_FLOPS))
    return 100.0 * bound / t if bound > 0 else None
