"""K2's share of its roofline: the sum of every int8 conv's bound (max of
its operations at the int8 peak and its bf16 input, int8 weights and bf16
output bytes at the memory's peak; `benchmark/count/ops.py`) over the
profiled frames, divided by the device time of the K2 kernels (K2a's
quantize pass, K2b, the stem kernel, the gather kernel) named below."""
from benchmark.count import ops

INCLUDE = ("int8_conv_nhwc_kernel", "quantize_nhwc", "int8_stem_kernel", "int8_conv_kernel")


def read(t):
    peaks = ops.peaks_for(t.device_kind)
    convs = [i for i in t.work if i["kind"] == "conv" and i["precision"] == "int8"]
    seconds = t.family_seconds(INCLUDE)
    if peaks is None or not convs or not seconds:
        return None
    return 100.0 * t.trace.frames * sum(ops.bound_s(i, peaks) for i in convs) / seconds
