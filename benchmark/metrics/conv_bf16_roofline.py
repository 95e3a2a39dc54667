"""The bf16 convs' share of their roofline: the sum of every conv's bound
(max of its operations at the bf16 peak and its input, weights and output
bytes at the memory's peak; `benchmark/count/ops.py`) over the profiled
frames, divided by the device time of the conv kernels named below.
cuDNN's conv kernels alone: PyTorch's separate bias-add kernels are
elementwise time, so a conv that fuses its bias moves this share down a
little while `fps` rises."""
from benchmark.count import ops

#: cuDNN's conv kernels on the card (forward propagation, implicit GEMM).
INCLUDE = ("fprop", "conv", "cudnn", "implicit")
#: Not convs: PyTorch's elementwise and copy kernels, cuDNN's layout
#: transposes, and the program's int8 kernels.
EXCLUDE = ("elementwise", "copy", "Copy", "nchwToNhwc", "nhwcToNchw", "int8_", "quantize_")


def read(t):
    peaks = ops.peaks_for(t.device_kind)
    convs = [i for i in t.work if i["kind"] == "conv" and i["precision"] == "bf16"]
    seconds = t.family_seconds(INCLUDE, EXCLUDE)
    if peaks is None or not convs or not seconds:
        return None
    return 100.0 * t.trace.frames * sum(ops.bound_s(i, peaks) for i in convs) / seconds
