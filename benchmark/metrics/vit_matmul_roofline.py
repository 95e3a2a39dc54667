"""The GEMMs' share of their roofline in a ViTPose cell: the sum of every
"matmul" item's bound (max of its operations at the bf16 peak and its
input, weight and output bytes at the memory's peak; `benchmark/count/
vit.py`: ViTPose's blocks' qkv, proj, fc1 and fc2, and the
preprocessing's resample products) over the profiled frames, divided by
the device time of the GEMM kernels named below. cuDNN's convs (the
detector, the patch embedding's 16x16 conv, the head's transposed convs,
all counted as kind "conv"), the fused attention and the elementwise
passes are not GEMMs here."""
from benchmark.count import ops

#: cuBLAS's GEMM kernels on the card (its sm90 `gemm` and `nvjet` kernels,
#: CUTLASS's).
INCLUDE = ("gemm", "nvjet", "cutlass")
#: Not GEMMs: cuDNN's convs (implicit-GEMM fprop and dgrad kernels), the
#: fused attention, elementwise and copy kernels.
EXCLUDE = ("fprop", "dgrad", "wgrad", "implicit", "conv", "cudnn", "flash", "fmha",
           "attention", "elementwise", "copy", "Copy")


def read(t):
    peaks = ops.peaks_for(t.device_kind)
    items = [i for i in t.work if i["kind"] == "matmul"]
    seconds = t.family_seconds(INCLUDE, EXCLUDE)
    if peaks is None or not any(i["net"] == "vitpose" for i in items) or not seconds:
        return None
    return 100.0 * t.trace.frames * sum(ops.bound_s(i, peaks) for i in items) / seconds
