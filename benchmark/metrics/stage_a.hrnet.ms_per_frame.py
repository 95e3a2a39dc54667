"""HRNet's device ms a frame in stage A: the device time of the program's
`stage_a.hrnet` spans (`pipeline/facade.py` `_clip_detections`, the pose
net's forward over the crops), over the traced slice's frames; read as
`stage_a.yolov3.ms_per_frame` is."""
from benchmark.harness import load_module

_yolov3 = load_module("metrics", "stage_a.yolov3.ms_per_frame")


def read(t):
    return _yolov3.per_frame(t, "stage_a.hrnet")
