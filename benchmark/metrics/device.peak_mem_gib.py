"""The card's peak of allocated memory over the window, in GiB
(`max_memory_allocated` after `reset_peak_memory_stats` at its start)."""


def read(t):
    return t.peak_bytes / 2**30 if t.peak_bytes else None
