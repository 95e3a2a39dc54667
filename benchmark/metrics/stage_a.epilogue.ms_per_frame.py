"""The one-pass conv epilogue's device ms a frame in stage A: the device
time of the program's `bias_act_nhwc` kernels (`tpupose_torch/csrc/
epilogue.cu`, the bias, upsample, residual and activation after each conv)
in the traced slice, over its frames. None where the slice ran none (a
program without the kernel, or one whose convs all kept the composed ops)."""

FAMILY = ("bias_act_nhwc",)


def read(t):
    seconds = t.family_seconds(FAMILY)
    return 1e3 * seconds / t.trace.frames if seconds and t.trace.frames else None
