"""Device kernels a frame of stage B: the kernels the profiler sees start
inside the profiled `track_clip` spans, divided by the profiled frames.
Fusing stage B's elementwise chains lowers it."""


def read(t):
    kernels = t.kernels_in("stage_b")
    if not kernels or not t.trace.frames:
        return None
    return len(kernels) / t.trace.frames
