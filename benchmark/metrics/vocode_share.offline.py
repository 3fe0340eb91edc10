"""vocode_share.offline: the share of the traced batch's wall (from its
start to its return) spent inside the vocoder (``AudioTokenizer.decode``,
which returns host arrays, so its wall is synchronized), timed by the
benchmark around the call."""


def read(facts, trace):
    tb = facts.get("traced_batch")
    if not tb or not tb["wall_s"]:
        return None
    return 100.0 * tb["vocode_s"] / tb["wall_s"]
