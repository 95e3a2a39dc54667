"""The program's spans and set-up counters (`tpupose_torch.utils.timing`).

* Off (no profiler, no `recording()`): `span()` returns one shared no-op,
  opens no profiler range, records nothing and allocates nothing.
* Under a CPU `torch.profiler` session a tiny `Pipeline.process_clip` emits
  exactly the spans of stage A's batch and its parts and stage B's clip,
  once each, as `span:*` ranges nested in `stage_a.batch`, none under the
  benchmark's own names; the store holds the same spans with parent ids and
  one clip id a call, and no device time off CUDA.
* `recording()` fills the store without a profiler; the store is bounded;
  a span is a no-op while the current stream captures a CUDA graph.
* A span times the device of the tensor it is given, and has no device
  time for a CPU tensor even where CUDA is initialized.
* `setup_seconds()` counts `quantize_models`; the benchmark's capture
  reader counts a new `CapturedStep`'s warm-ups and capture.
* The benchmark's readers of these spans and counters, loaded by path.
* `cli.evalmodel --profile` writes the trace and prints the span lines,
  and says "not measured" of a span name whose spans the store dropped.
* `chip_smoke.py`'s profile readers leave the spans' device-side copies
  out of the kernels.
* On the card (marked `card`): positive device ms, the parts within the
  batch, and a training step captured inside `recording()` still equal to
  the eager step. Run it there with
  `python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_spans.py`
  (the tests' conftest imports JAX, which a card host need not have).
"""
import contextlib
import copy
import importlib.util
import itertools
import tracemalloc
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpupose_torch.models.hrnet as th
import tpupose_torch.models.yolov3 as ty
import tpupose_torch.parallel.throughput as tp
import tpupose_torch.tracking.tracker as tt
from tpupose_torch.cli import evalmodel
from tpupose_torch.data.synthetic import make_scene
from tpupose_torch.geometry import make_camera_set
from tpupose_torch.parallel import broadcast_cameras, init_multistream_state
from tpupose_torch.pipeline import Pipeline
from tpupose_torch.runtime import graphs
from tpupose_torch.utils import timing

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TRACK = dict(num_cameras=3, max_dets=8, max_tracks=8, max_hyp=16)
STAGE_A_PARTS = ("stage_a.resize", "stage_a.yolov3", "stage_a.nms", "stage_a.crop",
                 "stage_a.hrnet", "stage_a.k1")
CLIP_SPANS = ("stage_a.batch",) + STAGE_A_PARTS + ("stage_b.clip",)
#: The benchmark's own span names, which readers select by exact name.
BENCHMARK_NAMES = ("stage_a", "stage_b", "slice")


@pytest.fixture(autouse=True)
def empty_store():
    timing.clear_spans()
    yield
    timing.clear_spans()


def _pipeline(device="cpu"):
    scene = make_scene(num_frames=1, num_cameras=3, num_actors=2, seed=0)
    gen = torch.Generator().manual_seed(0)
    return Pipeline(make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height),
                    tt.TrackerConfig(**TRACK), ty.tiny_yolo_test_config(),
                    ty.yolov3_init(ty.tiny_yolo_test_config(), gen), th.tiny_test_config(),
                    th.hrnet_init(th.tiny_test_config(), gen), device=device)


def _clip(frames=4):
    return np.random.default_rng(0).integers(0, 255, size=(frames, 3, 96, 128, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def warm_pipe():
    """A tiny CPU pipeline whose tracker step is already made, so that a
    clip adds no set-up span."""
    pipe = _pipeline()
    pipe.process_clip(np.arange(4), _clip())
    return pipe


def test_off_span_is_a_shared_noop(monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("a span opened a profiler range while off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert timing.span("stage_a.batch") is timing.span("stage_b.clip")
    assert timing.clip() is timing.span("stage_a.batch")
    with timing.clip(), timing.span("stage_a.batch"), timing.span("stage_a.hrnet"):
        pass
    assert timing.spans() == []


def test_off_span_allocates_nothing():
    def peak(body, n=20000):
        tracemalloc.reset_peak()
        start, _ = tracemalloc.get_traced_memory()
        body(n)
        now, top = tracemalloc.get_traced_memory()
        return now - start, top - start

    def empty(n):
        for _ in itertools.repeat(None, n):
            pass

    def calls(n):
        for _ in itertools.repeat(None, n):
            timing.clip()
            timing.span("stage_a.batch")

    noop = timing.span("stage_a.batch")

    def withs(n):
        for _ in itertools.repeat(None, n):
            with timing.clip(), timing.span("stage_a.batch"):
                pass

    def noop_withs(n):  # a `with` statement's own bound method, for comparison
        for _ in itertools.repeat(None, n):
            with noop, noop:
                pass

    def least(body):  # another thread's allocations can only raise a reading
        return min(peak(body) for _ in range(3))

    for body in (calls, withs, noop_withs):
        body(10)
    tracemalloc.start()
    try:
        assert least(calls) == least(empty)
        assert least(withs) == least(noop_withs)
    finally:
        tracemalloc.stop()
    assert timing.spans() == []


def test_profiled_clip_emits_the_span_set(warm_pipe):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        warm_pipe.process_clip(np.arange(4, 8), _clip())
    ranges = {}
    for e in prof.events():
        if e.name.startswith("span:"):
            assert e.name not in ranges, f"{e.name} twice in one clip"
            ranges[e.name] = (e.time_range.start, e.time_range.end)
    assert sorted(ranges) == sorted("span:" + n for n in CLIP_SPANS)
    assert not {"span:" + n for n in BENCHMARK_NAMES} & set(ranges)
    lo, hi = ranges["span:stage_a.batch"]
    for name in STAGE_A_PARTS:
        a, b = ranges["span:" + name]
        assert lo <= a <= b <= hi, name
    assert ranges["span:stage_b.clip"][0] >= hi

    records = timing.spans()
    assert [r.name for r in records] == list(CLIP_SPANS)
    by_name = {r.name: r for r in records}
    batch = by_name["stage_a.batch"]
    assert batch.parent is None and by_name["stage_b.clip"].parent is None
    assert all(by_name[n].parent == batch.id for n in STAGE_A_PARTS)
    assert len({r.clip for r in records}) == 1 and batch.clip is not None
    assert len({r.id for r in records}) == len(records)
    assert all(r.device_ms is None and r.start_ns <= r.end_ns for r in records)


def test_recording_fills_the_store_without_a_profiler(warm_pipe):
    with timing.recording():
        warm_pipe.process_clip(np.arange(8, 12), _clip())
        warm_pipe.process_clip(np.arange(12, 16), _clip())
    warm_pipe.process_clip(np.arange(16, 20), _clip())  # shut: not recorded
    records = timing.spans()
    assert [r.name for r in records] == list(CLIP_SPANS) * 2
    clips = [r.clip for r in records]
    assert len(set(clips[:len(CLIP_SPANS)])) == len(set(clips[len(CLIP_SPANS):])) == 1
    assert clips[0] != clips[-1]


def test_the_store_keeps_the_newest_spans():
    with timing.recording():
        for _ in range(timing.STORE_SPANS + 10):
            with timing.span("stage_a.batch"):
                pass
    records = timing.spans()
    assert len(records) == timing.STORE_SPANS
    ids = [r.id for r in records]
    assert ids == list(range(ids[0], ids[0] + timing.STORE_SPANS))
    assert timing.dropped_spans() == {"stage_a.batch": 10}
    timing.clear_spans()
    assert timing.spans() == [] and timing.dropped_spans() == {}


def test_parents_and_clip_ids():
    with timing.recording():
        with timing.span("stage_a.batch"):
            with timing.span("stage_a.hrnet"):
                pass
        with timing.clip():
            with timing.span("stage_a.batch") as outer:
                with timing.clip():  # a nested call keeps its caller's clip
                    with timing.span("stage_a.yolov3"):
                        pass
        with timing.clip():
            with timing.span("stage_b.clip"):
                pass
    free, inner, clipped, nested, second = timing.spans()
    assert (free.parent, inner.parent) == (None, free.id)
    assert free.clip is None and inner.clip is None
    assert clipped is outer and nested.parent == outer.id
    assert nested.clip == clipped.clip is not None
    assert second.clip not in (None, clipped.clip)


def test_span_is_a_noop_while_a_graph_captures(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with timing.recording():
        assert timing.span("stage_a.hrnet") is timing.span("stage_b.clip")
        with timing.span("stage_a.hrnet"):
            pass
    assert timing.spans() == []


def test_multistream_clip_is_one_clip(warm_pipe):
    tcfg = tt.TrackerConfig(**TRACK)
    fn = tp.make_multistream_clip_fn(ty.tiny_yolo_test_config(), th.tiny_test_config(),
                                     tcfg, chunk_frames=1)
    clip = torch.as_tensor(np.stack([_clip(2), _clip(2)]))
    args = (warm_pipe.detector, warm_pipe.pose_model, broadcast_cameras(warm_pipe.cams, 2))
    fids = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    fn(*args, init_multistream_state(tcfg, 2, "cpu"), clip, fids)  # makes the step
    with timing.recording():
        fn(*args, init_multistream_state(tcfg, 2, "cpu"), clip, fids)
    records = timing.spans()
    assert [r.name for r in records] == ["stage_a.batch", *STAGE_A_PARTS] * 2 + ["stage_b.clip"]
    assert len({r.clip for r in records}) == 1 and records[0].clip is not None


def test_a_cpu_span_has_no_device_time(monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("a span of CPU work made a CUDA event")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with timing.recording():
        with timing.span("stage_a.batch", torch.zeros(2)):
            with timing.span("stage_a.hrnet"):
                pass
    records = timing.spans()
    assert [(r.name, r.device, r.device_ms) for r in records] == [
        ("stage_a.batch", None, None), ("stage_a.hrnet", None, None)]


def test_setup_seconds_count_quantize():
    pipe = _pipeline()
    before = timing.setup_seconds().get("quantize", 0.0)
    pipe.quantize_models(_clip(8)[:, 0], on_drift="warn")
    assert timing.setup_seconds()["quantize"] > before


class _Pair(NamedTuple):
    x: torch.Tensor


def test_setup_seconds_count_a_new_capture(monkeypatch):
    """The benchmark's `setup.capture_s` reads the runtime's own figures of
    every captured step of the process: a new one adds its warm-ups and its
    capture, and records no span of its own."""
    def fn(cams, state, dets, mask, frame_id):
        return _Pair(state.x + dets.sum()), _Pair(state.x * 2)

    monkeypatch.syspath_prepend(str(ROOT))
    read = _reader("setup.capture_s")
    before = read(None) or 0.0
    with timing.recording():
        step = graphs.CapturedStep(fn, _Pair(torch.zeros(2)), _Pair(torch.ones(3)),
                                   torch.ones(4), torch.ones(4, dtype=torch.bool), 0)
    monkeypatch.setitem(graphs._STEPS, ("spans test",), step)
    assert read(None) == pytest.approx(before + step.warmup_s + step.capture_s)
    assert step.warmup_s > 0 and timing.spans() == []
    state, out = step.step(step.cams, _Pair(torch.ones(3)), torch.ones(4),
                           torch.ones(4, dtype=torch.bool), 1)
    assert torch.equal(state.x, torch.full((3,), 5.0)) and torch.equal(out.x, torch.full((3,), 2.0))


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("spans_reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _record(name, ms):
    record = timing.Span(name)
    record.device_ms = ms
    return record


#: reader -> (its value on STORE over 8 frames, on SETUP).
READINGS = {
    "stage_a.yolov3.ms_per_frame": 16.0 / 8,
    "stage_a.hrnet.ms_per_frame": 64.0 / 8,
    "stage_a.glue.ms_per_frame": (100.0 - 16.0 - 64.0) / 8,
    "setup.capture_s": 1.5,
    "setup.quantize_s": 4.25,
}
STORE = [("stage_a.batch", 60.0), ("stage_a.yolov3", 6.0), ("stage_a.nms", 1.0),
         ("stage_a.hrnet", 30.0), ("stage_b.clip", 9.0), ("stage_a.batch", 40.0),
         ("stage_a.yolov3", 10.0), ("stage_a.hrnet", 34.0)]
SETUP = {"quantize": 4.25}
#: the process's captured steps, (warm-up s, capture s) each
STEPS = [(1.0, 0.25), (0.125, 0.125)]


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    read = _reader(name)
    t = SimpleNamespace(trace=SimpleNamespace(frames=8))
    monkeypatch.setattr(timing, "spans", lambda: [_record(n, ms) for n, ms in STORE])
    monkeypatch.setattr(timing, "setup_seconds", lambda: dict(SETUP))
    monkeypatch.setattr(graphs, "steps", lambda: {
        k: SimpleNamespace(warmup_s=w, capture_s=c) for k, (w, c) in enumerate(STEPS)})
    assert read(t) == pytest.approx(READINGS[name])
    # nothing recorded, or no device time (a CPU run): no number
    monkeypatch.setattr(timing, "spans", lambda: [])
    monkeypatch.setattr(timing, "setup_seconds", lambda: {})
    monkeypatch.setattr(graphs, "steps", lambda: {})
    assert read(t) is None
    monkeypatch.setattr(timing, "spans", lambda: [_record(n, None) for n, _ in STORE])
    if name.startswith("stage_a."):
        assert read(t) is None
        # some of the spans dropped from the bounded store: no number either
        monkeypatch.setattr(timing, "spans", lambda: [_record(n, ms) for n, ms in STORE])
        monkeypatch.setattr(timing, "dropped_spans", lambda: {n: 1 for n, _ in STORE})
        assert read(t) is None
    # a program without the recorder (the parent of these readers)
    monkeypatch.delattr(timing, "spans")
    monkeypatch.delattr(timing, "setup_seconds")
    assert read(t) is None


def test_evalmodel_profile_writes_the_trace_and_span_lines(tmp_path, capsys):
    evalmodel.main(["--synthetic", "--frames", "6", "--device", "cpu"])
    plain = capsys.readouterr().out
    out_dir = tmp_path / "profile"
    evalmodel.main(["--synthetic", "--frames", "6", "--device", "cpu",
                    "--profile", str(out_dir)])
    profiled = capsys.readouterr().out.splitlines()
    lines = plain.splitlines()
    # the same report (its times aside), then one line per span name
    assert [line.split(":")[0] for line in profiled[:len(lines)]] == [
        line.split(":")[0] for line in lines]
    assert not any(line.startswith("span ") for line in lines)
    assert profiled[len(lines):] == [
        "span stage_b.clip: device time not measured (1 span)"]
    data = (out_dir / "trace.json").read_bytes()
    assert data.count(b'"span:stage_b.clip"') == 1


def test_evalmodel_profile_says_not_measured_past_the_store(tmp_path, capsys, monkeypatch):
    """A run longer than the store keeps: the report names the span and says
    that the store dropped spans, and prints no figure for it."""
    monkeypatch.setattr(timing, "STORE_SPANS", 0)
    evalmodel.main(["--synthetic", "--frames", "6", "--device", "cpu",
                    "--profile", str(tmp_path / "profile")])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("span ")]
    assert lines == ["span stage_b.clip: device time not measured, the store overflowed "
                     "(1 dropped, 0 spans kept)"]


def test_chip_smoke_profiles_leave_out_the_span_ranges(monkeypatch):
    """The profiler mirrors each `span:*` range onto the device's timeline:
    chip_smoke's profile readers count kernels and copies alone."""
    spec = importlib.util.spec_from_file_location("chip_smoke_spans", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def event(name, start, end, device=torch.autograd.DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [event("span:stage_a.batch", 0, 100), event("void k2b_kernel<1>", 0, 10),
              event("span:stage_b.clip", 100, 400), event("Memcpy DtoD", 20, 30),
              event("span:stage_a.batch", 0, 100, torch.autograd.DeviceType.CPU)]

    @contextlib.contextmanager
    def fake_profile(**kwargs):
        yield SimpleNamespace(events=lambda: events)

    monkeypatch.setattr(torch.profiler, "profile", fake_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    one = smoke.profiled_device_events(torch, lambda: None)
    assert (one["device_events"], one["memcpy_memset"], one["busy_us"], one["window_us"]) == (
        2, 1, 20, 30)
    fams = smoke.profiled_families(torch, lambda: None)
    assert fams["device_events"] == 2 and fams["busy_ms"] == pytest.approx(0.02)
    assert sum(fams["family_ms"].values()) == pytest.approx(0.02)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_device_ms_and_a_captured_step_inside_recording(card):
    pipe = _pipeline(card)
    clip = torch.as_tensor(_clip(), device=card)
    pipe.process_clip(np.arange(4), clip)
    with timing.recording():
        pipe.process_clip(np.arange(4, 8), clip)
    records = timing.spans()
    assert [r.name for r in records] == list(CLIP_SPANS)
    assert all(r.device_ms > 0 for r in records), records
    batch = records[0].device_ms
    assert sum(r.device_ms for r in records[1:-1]) <= batch + 2e-3  # event ticks: 0.5 us

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 1)).to(card)
    twin = copy.deepcopy(model)
    batches = [(torch.randn(8, 16, device=card), torch.randn(8, 1, device=card))
               for _ in range(6)]

    def make(net):
        def loss_fn(x, y):
            with timing.span("stage_a.hrnet"):
                return torch.nn.functional.mse_loss(net(x), y)
        return graphs.CapturedUpdate(loss_fn, torch.optim.Adam(net.parameters(), lr=1e-2,
                                                               capturable=True))

    step, ref = make(model), make(twin)
    timing.clear_spans()
    with timing.recording():
        losses = [step(*b) for b in batches]
    with graphs.disable_capture():
        ref_losses = [ref(*b) for b in batches]
    assert step.stats()[0]["replays"] == len(batches) - graphs.WARMUP
    for a, b in zip(losses, ref_losses):
        assert torch.equal(a, b)
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.equal(p, q)
    # the warm-ups ran the span eagerly; the capture and replays hold none
    assert [r.name for r in timing.spans()] == ["stage_a.hrnet"] * graphs.WARMUP
