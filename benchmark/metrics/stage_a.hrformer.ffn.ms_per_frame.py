"""HRFormer's conv FFN halves' device ms a frame in stage A: the device
time of the program's `stage_a.hrformer.ffn` spans (`models/hrformer.py`
`HRFormerBlock.forward`: LayerNorm, fc1, the depthwise dw3x3 and fc2 on
cuDNN, each with its bias and GELU in one epilogue pass, fc2's taking the
residual add, 44 a forward), over the traced slice's frames; read as
`stage_a.yolov3.ms_per_frame` is. None where the program has no such
spans."""
from benchmark.harness import load_module

_yolov3 = load_module("metrics", "stage_a.yolov3.ms_per_frame")


def read(t):
    return _yolov3.per_frame(t, "stage_a.hrformer.ffn")
