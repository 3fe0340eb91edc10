"""idle_share.arrivals: 1 - (the union of the kernels' intervals) / (the
traced stretch's wall), over a stretch of the window from one segment boundary to another
(admissions, segments, vocoding)."""


def read(facts, trace):
    if trace is None or trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
