"""The 90th percentile of every call's latency in the window, from handing
the clip to the entry to its outputs complete on the card, in ms."""
from benchmark.harness import quantile


def read(w):
    return 1e3 * quantile(w.latencies, 0.9)
