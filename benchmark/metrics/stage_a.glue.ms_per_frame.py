"""Stage A's device ms a frame outside its two networks: the program's
`stage_a.batch` spans less its `stage_a.yolov3` and `stage_a.hrnet` spans
(the resize, the decode / top-K / NMS, the crops, K1 and the padding to
the tracker's detections), over the traced slice's frames; read as
`stage_a.yolov3.ms_per_frame` is."""
from benchmark.harness import load_module

_yolov3 = load_module("metrics", "stage_a.yolov3.ms_per_frame")


def read(t):
    parts = [_yolov3.per_frame(t, n) for n in ("stage_a.batch", "stage_a.yolov3",
                                               "stage_a.hrnet")]
    return None if None in parts else parts[0] - parts[1] - parts[2]
