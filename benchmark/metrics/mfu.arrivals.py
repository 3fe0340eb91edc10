"""mfu.arrivals: the model FLOPs of the rows that the window's segments
advanced (each live row's tokens through the decoder, attending over its
own keys and text, and the head; ``harness/costs.py``) over the segments'
synchronized wall, over the bf16 peak (989 TFLOP/s): the step's share of
the chip, whatever kernels run it."""

from benchmark.harness import costs


def read(facts, trace):
    segs = facts.get("segments")
    if not segs:
        return None
    c = facts["config"]
    w = costs.widths_of(c)
    layers = int(c["num_decoder_layers"])
    va = int(c["tts"]["audio_vocab_size"]) + 5
    flops = 0
    for s in segs:
        for plen, g0, adv, xlen in s["rows"]:
            flops += (costs.decoder_flops(w, layers, adv, plen + g0 + 1, xlen)
                      + costs.head_flops(w, adv, va))
    wall = sum(s["end"] - s["start"] for s in segs)
    if not flops or wall <= 0:
        return None
    return 100.0 * flops / wall / costs.PEAKS[facts["precision"]]
