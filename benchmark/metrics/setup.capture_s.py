"""Seconds the process spent making the tracker's captured steps: each
`runtime/graphs.py` `CapturedStep`'s eager warm-ups, ended by a device
sync, and its capture (`warmup_s` + `capture_s`), summed over the
process's steps (`graphs.steps()`). The warm-ups are the step's first
eager runs, so they hold its first use of the kernels and libraries; the
capture alone is a small part. Part of `setup_s`. None where the process
made no such step."""


def read(t):
    from tpupose_torch.runtime import graphs

    made = list(getattr(graphs, "steps", dict)().values())
    return sum(s.warmup_s + s.capture_s for s in made) if made else None
