"""mfu.offline: the model FLOPs of the traced batch's requests (encoder,
cross K/V, the prefill of BOS, each generated token through the decoder
and the head, worked out from shapes at their real lengths by
``harness/costs.py``) over that batch's wall, from its start to its
return, over the card's int8 peak (1,979 TOP/s): the whole step's share of
the chip, which bounds what any one kernel's gain can give."""

from benchmark.harness import costs


def read(facts, trace):
    tb = facts.get("traced_batch")
    if not tb or not tb["wall_s"] or not tb["model_flops"]:
        return None
    return 100.0 * tb["model_flops"] / tb["wall_s"] / costs.PEAKS[
        facts["precision"]]
