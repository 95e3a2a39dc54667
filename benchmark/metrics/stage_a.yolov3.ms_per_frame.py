"""YOLOv3's device ms a frame in stage A: the device time of the program's
`stage_a.yolov3` spans (`models/yolov3.py` `detect_people`, the detector's
forward; CUDA events on the stream, `tpupose_torch.utils.timing.spans()`),
over the traced slice's frames. The program records spans only while the
profiler runs, so its store holds the traced slice's alone. None where the
program has no such spans, no device time for them, or dropped some of
them from its bounded store."""


def device_ms(name):
    """The summed device ms of the program's spans named `name`, or None."""
    from tpupose_torch.utils import timing

    spans = getattr(timing, "spans", None)
    if spans is None or getattr(timing, "dropped_spans", dict)().get(name):
        return None
    ms = [s.device_ms for s in spans() if s.name == name]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms)


def per_frame(t, name):
    total = device_ms(name)
    return total / t.trace.frames if total is not None and t.trace.frames else None


def read(t):
    return per_frame(t, "stage_a.yolov3")
