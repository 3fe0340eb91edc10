"""idle_share.offline: 1 - (the union of the kernels' intervals) / (the
traced stretch's wall), over one whole batch of the window (prefill,
steps, vocoding)."""


def read(facts, trace):
    if trace is None or trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
