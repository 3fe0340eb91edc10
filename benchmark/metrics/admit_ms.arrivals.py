"""admit_ms.arrivals: the mean wall of one continuous admission
(``decode/continuous.py::admit``: the batch-1 eager prefill and the row's
install), synchronized before and after by the benchmark's wrapper of the
server's ``_fns.admit`` in the traced run, over the window's admissions.
Every resident slot waits for it."""


def read(facts, trace):
    walls = facts.get("admit_walls_s")
    return 1e3 * sum(walls) / len(walls) if walls else None
