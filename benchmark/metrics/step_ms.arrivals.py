"""step_ms.arrivals: the synchronized wall of the window's segments (the
captured per-row-clock body, ``continuous.make_fns(...).segment``,
replayed ``segment_frames`` times) over the step bodies they ran."""


def read(facts, trace):
    segs = facts.get("segments")
    if not segs:
        return None
    bodies = sum(s["bodies"] for s in segs)
    return 1e3 * sum(s["end"] - s["start"] for s in segs) / bodies
