"""Stage timing helpers (device-aware).

Counterpart of `tpupose/utils/timing.py`. Mirrors the reference's per-stage
s/frame + fps report (`src/testmodel.py:92-99`); a stage timed with a CUDA
tensor as `block_on` synchronizes that tensor's device before the clock
stops, so device work is measured and not only its launch. The report's
text is the JAX package's, line for line.
"""
from __future__ import annotations

import contextlib
import time

import torch


def _sync(block_on):
    """Wait for the device of every CUDA tensor in `block_on`: a tensor or a
    (nested) tuple or list of them, such as a FrameOutput."""
    if torch.is_tensor(block_on):
        if block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
    elif isinstance(block_on, (tuple, list)):
        for v in block_on:
            _sync(v)


class StageTimer:
    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def time(self, stage: str, block_on=None):
        start = time.perf_counter()
        yield
        if block_on is not None:
            _sync(block_on)
        self.totals[stage] = self.totals.get(stage, 0.0) + time.perf_counter() - start
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def add(self, stage: str, seconds: float, count: int = 1):
        self.totals[stage] = self.totals.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + count

    def per_frame(self, stage: str):
        c = self.counts.get(stage, 0)
        return self.totals.get(stage, 0.0) / c if c else 0.0

    def report(self, num_views: int = 1):
        """Reference-format report (`src/testmodel.py:92-99`)."""
        det = self.per_frame("person_detect")
        pose = self.per_frame("pose_detect")
        track = self.per_frame("track")
        lines = [
            f"Person Detect Processing time (s/f): {det:f}",
            f"Pose Detect Processing time (s/f): {pose:f}",
            f"Track Processing time (s/f): {track:f}",
        ]
        denom = (det + pose) / max(num_views, 1) + track
        if denom > 0:
            lines.append(f"fps: {1.0 / denom:f}")
        if track > 0:
            lines.append(f"tracking fps: {1.0 / track:f}")
        if "decode_work" in self.totals:
            # Decode workers' own per-frame decode time; the PIL source
            # never records it (it is the native loader's stage).
            lines.append(
                f"Decode work (s/f): {self.per_frame('decode_work'):f}"
            )
        if "decode_wait" in self.totals:
            # Host-thread stall waiting for the next decoded frame (the
            # full serial decode cost on the PIL source). Not part of the
            # reference report format (its decode is unmeasured, inside
            # the timed loop — src/dataset.py:36-45).
            lines.append(
                f"Decode wait (s/f): {self.per_frame('decode_wait'):f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional torch.profiler trace of the CPU and, where present, the
    CUDA activity, written to `logdir` as a Chrome trace."""
    if not logdir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
