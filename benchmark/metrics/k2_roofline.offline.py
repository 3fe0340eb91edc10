"""k2_roofline.offline: kernel 2 (``ops/megakernel.py::decode_stack`` ->
``csrc/decode_layer.cu``, its GEMVs on ``csrc/w8a8.cuh``) over one traced
batch: the least time the card could take for the batch's decode steps
over the device time of those kernels.

The bound counts, for every step and every layer, the layer's weights
(int8, or int4 levels at 0.5 byte) with their f32 scales and norms, and
for each row still generating its valid K/V (int8 pages with f32 scales)
of BOS, its generated tokens so far and its text, with h in and out
(``harness/costs.decode_layer_bytes``); and the head's two W8A8 GEMVs at
the live rows (kernel 3 at M <= 16, which runs ``w8a8.cuh``'s GEMV under
the same kernel name, so its time is in the sum). The prefill's
activation quantization (``quantize_rows``) shares a name too and is
counted in the time but not the bound. Each step's bound is the larger of
its bytes over 3.35 TB/s and its integer operations over 1,979 TOP/s."""

from benchmark.harness import costs

KERNELS = (r"\((?:anonymous namespace)\)::(?:residual_norm_quant|rope|"
           r"geglu_quant|geglu_part|slab_logits|slab_split|merge_quant)"
           r"_kernel|t5g::(?:quantize_rows|w8a8_gemv|row_absmax|"
           r"quantize_tiles|gemv_int|rescale_tiles)_kernel")


def step_bound_s(w, layers, va, rows, kv_elem, kv_scales, w_bytes):
    m = len(rows)
    nbytes = layers * costs.decode_layer_bytes(w, rows, kv_elem, kv_scales,
                                               w_bytes)
    kn = ((w.d, w.ho + 2 * w.nkv), (w.ho, w.d), (w.d, w.ho), (w.ho, w.d),
          (w.d, 2 * w.f), (w.f, w.d))
    ops = layers * sum(2 * m * k * n for k, n in kn)
    b1, o1 = costs.w8a8_cost(m, w.d, w.d, 1, 2)
    b2, o2 = costs.w8a8_cost(m, w.d, va, 1, 2, w_bytes)
    return costs.bound_s(nbytes + b1 + b2, ops + o1 + o2,
                         costs.PEAK_INT8_OPS)


def read(facts, trace):
    tb = facts.get("traced_batch")
    if not tb or trace is None:
        return None
    t = trace.time_s(KERNELS)
    if not t:
        return None
    c = facts["config"]
    w = costs.widths_of(c)
    layers = int(c["num_decoder_layers"])
    va = int(c["tts"]["audio_vocab_size"]) + 5
    bound = 0.0
    for s in range(int(tb["steps"])):
        # rows (BOS, tokens generated so far, text) still generating
        rows = [(p, s, e) for p, g, e in tb["rows"] if s < g]
        if rows:
            bound += step_bound_s(w, layers, va, rows, tb["kv_elem"],
                                  tb["kv_scales"], tb["w_bytes"])
    return 100.0 * bound / t if bound > 0 else None
