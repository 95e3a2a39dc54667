"""The whole step's share of the card's peak: the least time one frame's
convs and matmuls could take, each at the peak of its precision (bf16 or
int8; `benchmark/count/ops.py`), times the profiled frames, divided by the
profiled slice's wall time."""
from benchmark.count import ops


def read(t):
    peaks = ops.peaks_for(t.device_kind)
    if peaks is None or not t.work or not t.trace.slice_s:
        return None
    least = sum(i["ops"] / (peaks["int8_ops"] if i["precision"] == "int8" else peaks["bf16_flops"])
                for i in t.work)
    return 100.0 * t.trace.frames * least / t.trace.slice_s
