"""Stage timing helpers (device-aware) and the program's span recorder.

`StageTimer` is the counterpart of `tpupose/utils/timing.py`. It mirrors
the reference's per-stage s/frame + fps report (`src/testmodel.py:92-99`);
a stage timed with a CUDA tensor as `block_on` synchronizes that tensor's
device before the clock stops, so device work is measured and not only its
launch. The report's text is the JAX package's, line for line.

Spans mark the program's layers where the work happens (`span(name, on)`):
stage A's batch and its parts in `pipeline.facade` and `models.yolov3`,
stage B's clip where `tracking.track_clip` and the multi-stream clip
function replay the captured step, and the set-up phase of
`Pipeline.quantize_models` (`setup_phase`). A span is off unless a `torch.profiler` session is
recording or a `recording()` block is open; off, it is one flag check and
one `torch.autograd._profiler_enabled()` call, and returns a shared no-op.

* Under the profiler a span opens `record_function("span:" + name)`, so the
  layers sit on the profiler's timeline beside the kernels. The names start
  with `span:`, which the profiler also mirrors onto the device's timeline,
  where a reader of the trace tells them from kernels by that prefix.
* Under the profiler or inside `recording()` a span also records into the
  store: its name, id, parent's id (a per-thread stack), clip id (`clip()`),
  host start and end (`time.perf_counter_ns`) and its device ms, from a
  pair of CUDA events taken from a pool and recorded on the current stream
  of the device that holds `on`, a tensor of the span's work (None where
  `on` is not a CUDA tensor). `spans()` synchronizes once and resolves
  them; the store keeps the newest STORE_SPANS spans and counts, by name,
  those it dropped (`dropped_spans()`).
* While the current stream captures a CUDA graph a span is a no-op: a
  captured program holds no event and no range.

Set-up phases are counted whether spans are on or not: `setup_phase(name)`
adds its host seconds, ended by a device sync, to `setup_seconds()`.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
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


# -- spans -------------------------------------------------------------------------

#: Spans the store keeps: the newest ones.
STORE_SPANS = 65536

#: Open `recording()` blocks.
_recording = 0
#: Span records, oldest first.
_store: collections.deque = collections.deque()
#: name -> spans dropped from the store since it was last emptied.
_dropped: collections.Counter = collections.Counter()
#: device index -> free timing events.
_events: dict = {}
#: Per thread: `stack`, the open spans; `clip`, the open clip's id.
_local = threading.local()
_span_ids = itertools.count(1)
_clip_ids = itertools.count(1)
#: phase -> seconds of the process's set-up phases.
_setup: dict = {}

#: What `span` and `clip` return while off.
_OFF = contextlib.nullcontext()


class Span:
    """One span: `name`, `id`, `parent` (the enclosing span's id or None),
    `clip` (the clip's id or None), host `start_ns` and `end_ns`
    (`time.perf_counter_ns`), `device_ms` (None until `spans()` resolves
    its events, and where it has none: `device`, the CUDA device index
    whose stream it times, is None)."""

    __slots__ = ("name", "device", "id", "parent", "clip", "start_ns", "end_ns",
                 "device_ms", "_pair", "_range")

    def __init__(self, name, device=None):
        self.name, self.device = name, device
        self.end_ns = self.device_ms = self._pair = self._range = None

    def __enter__(self):
        stack = _stack()
        self.id = next(_span_ids)
        self.parent = stack[-1].id if stack else None
        self.clip = getattr(_local, "clip", None)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function("span:" + self.name)
            self._range.__enter__()
        if self.device is not None:
            self._pair = (_event(self.device), _event(self.device))
            self._pair[0].record(torch.cuda.current_stream(self.device))
        stack.append(self)
        _keep(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._pair is not None:
            self._pair[1].record(torch.cuda.current_stream(self.device))
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, clip={self.clip}, "
                f"device_ms={self.device_ms})")


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event(device):
    free = _events.setdefault(device, [])
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _recycle(record):
    """Hand a closed span's events back to the pool."""
    if record._pair is not None and record.end_ns is not None:
        _events[record.device].extend(record._pair)
        record._pair = None


def _keep(record):
    _store.append(record)
    if len(_store) > STORE_SPANS:
        old = _store.popleft()
        _dropped[old.name] += 1
        _recycle(old)


def _on():
    return _recording or torch.autograd._profiler_enabled()


def span(name: str, on: torch.Tensor | None = None):
    """A context manager marking one layer's work as the span `name` (see
    the module docstring). Names are the program's layers, `stage_a.*`,
    `stage_b.*` and `setup.*`. `on` is a tensor on the device that runs the
    work: the span times that device's current stream where it is a CUDA
    tensor, and has no device time otherwise."""
    if not _on():
        return _OFF
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return _OFF
    return Span(name, on.device.index if on is not None and on.is_cuda else None)


class _Clip:
    def __enter__(self):
        _local.clip = next(_clip_ids)

    def __exit__(self, *exc):
        _local.clip = None
        return False


def clip():
    """A context manager giving the spans inside it one clip id: a call of
    `Pipeline.process_clip`, of the multi-stream clip function or of
    `track_clip`. Inside an open clip it is a no-op, so a call keeps its
    caller's id; it adds no span of its own."""
    if not _on() or getattr(_local, "clip", None) is not None:
        return _OFF
    return _Clip()


@contextlib.contextmanager
def recording():
    """Inside the block every span records into the store, with or without
    a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list:
    """The store's spans, oldest first, their device ms resolved: one
    device synchronize where events are pending."""
    pending = [r for r in _store if r._pair is not None and r.end_ns is not None]
    for device in {r.device for r in pending}:
        torch.cuda.synchronize(device)
    for r in pending:
        r.device_ms = r._pair[0].elapsed_time(r._pair[1])
        _recycle(r)
    return list(_store)


def dropped_spans() -> dict:
    """{name: spans} the bounded store dropped since it was last emptied:
    a sum over `spans()` misses them."""
    return dict(_dropped)


def clear_spans():
    """Empty the store."""
    for r in _store:
        _recycle(r)
    _store.clear()
    _dropped.clear()


@contextlib.contextmanager
def setup_phase(phase: str):
    """The span `setup.<phase>` around one set-up phase, whose host seconds,
    ended by a synchronize of the current CUDA device, `setup_seconds()`
    adds up; the span itself has no device time. Also a decorator."""
    t0 = time.perf_counter()
    with span("setup." + phase):
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    _setup[phase] = _setup.get(phase, 0.0) + time.perf_counter() - t0


def setup_seconds() -> dict:
    """{phase: seconds} of the process's set-up phases so far."""
    return dict(_setup)


def span_report(frames: int) -> str:
    """One line per span name in the store: its device ms a frame over
    `frames` frames (a set-up phase's ms in all), or "not measured" where
    the spans have no device time or the store dropped some of them."""
    by_name: dict = {}
    for r in spans():
        by_name.setdefault(r.name, []).append(r.device_ms)
    for name in _dropped:
        by_name.setdefault(name, [])
    lines = []
    for name, ms in by_name.items():
        count = f"{len(ms)} span{'' if len(ms) == 1 else 's'}"
        if _dropped[name]:
            lines.append(f"span {name}: device time not measured, the store overflowed "
                         f"({_dropped[name]} dropped, {count} kept)")
        elif any(m is None for m in ms):
            lines.append(f"span {name}: device time not measured ({count})")
        elif name.startswith("setup."):
            lines.append(f"span {name}: {sum(ms):.3f} ms on the device in all ({count})")
        else:
            note = ("; read under CUPTI, its graph replays wait on the host"
                    if name.startswith("stage_b.") else "")
            lines.append(f"span {name}: {sum(ms) / max(frames, 1):.3f} device ms/frame "
                         f"({count}{note})")
    return "\n".join(lines)
