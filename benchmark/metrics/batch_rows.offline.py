"""batch_rows.offline: the mean rows a decode group of ``BatchingServer``
ran (its ``ServerStats.batch_sizes``, a count the program keeps)."""


def read(facts, trace):
    sizes = facts.get("batch_sizes")
    return sum(sizes) / len(sizes) if sizes else None
