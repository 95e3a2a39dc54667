"""The card's idle share inside stage A: over the profiled `stage_a` spans
(`Pipeline.process_clip_nn`, each ended by a device sync), 1 - (the union
of the kernels' intervals inside them / the spans' length), in percent.

Stage A's kernels are launched one by one and run long enough that the
profiler's cost on the host does not show in it. Stage B is left out: under
the profiler each replay of its captured graph costs the host more than
the graph's device time, so an idle share there reads the profiler."""
from benchmark.harness import union_us


def read(t):
    length = busy = 0.0
    for name, a, b in t.trace.spans:
        if name == "stage_a":
            inside = [(max(s, a), min(e, b)) for _, s, e in t.trace.kernels if e > a and s < b]
            busy += union_us(inside)[0]
            length += b - a
    return 100.0 * (1.0 - busy / length) if length else None
