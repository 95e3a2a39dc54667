"""ViTPose's head's device ms a frame in stage A: the device time of the
program's `stage_a.vitpose.head` spans (`models/vitpose.py`
`ViTPose.forward`: the two transposed convs with their bias and ReLU and
the heatmap layer), over the traced slice's frames; read as
`stage_a.yolov3.ms_per_frame` is. None where the program has no such
spans."""
from benchmark.harness import load_module

_yolov3 = load_module("metrics", "stage_a.yolov3.ms_per_frame")


def read(t):
    return _yolov3.per_frame(t, "stage_a.vitpose.head")
