"""The captured tracker step (`tpupose_torch.runtime.graphs`,
`tracking.tracker.make_step_fn`, `track_clip`, the multistream step) on
the CPU, where the same buffers run the eager step at each replay.

(a) Capturability: a CUDA graph replays one fixed sequence of kernels with
    fixed arguments, so the eager step must issue the same ops, with the
    same non-tensor arguments, shapes and dtypes, on every frame. The ops
    are recorded under a `TorchDispatchMode` over frames of an adversarial
    scene (false positives, drops, varying frame ids), after one warm-up
    step (as before a capture: the smoothing weights are made once a
    process), for the single step
    and the vmapped step at S = 1 and 3, at both capacity sets of the
    benchmark (4 / 12 / 24 and 16 / 16 / 40). A value-dependent Python
    branch or a frame id baked in as a constant would fail it. The LAP is
    one opaque op there, as K3 is one kernel in the graph.
(b) The buffer logic: the step equals `tracker_step` bit for bit on every
    state and output field; what it returned earlier stays unchanged; a
    restart, an older state and new or rewritten cams take effect.
(c) Parity with the JAX package's `make_step_fn` and `track_clip`: the
    discrete state exactly (tests/test_torch_streams.py's DISCRETE_STATE),
    pose3d within tests/test_torch_tracker.py's bands.
(d) Launch counters under simulated replays: a capture's launches are
    taken back and added again at each replay; the warm-up's stay counted.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from tpupose.geometry import make_camera_set as j_make_cams
from tpupose.tracking.tracker import TrackerConfig as JConfig
from tpupose.tracking.tracker import init_state as j_init
from tpupose.tracking.tracker import make_step_fn as j_make_step
from tpupose.tracking.tracker import track_clip as j_track_clip
import tpupose_torch.tracking.tracker as tt
from tpupose_torch.data.synthetic import make_continuous_adversarial_scene, make_scene
from tpupose_torch.geometry import CameraSet, make_camera_set
from tpupose_torch.ops import lap
from tpupose_torch.parallel import (
    broadcast_cameras,
    init_multistream_state,
    make_multistream_step_fn,
    multistream_step,
)
from tpupose_torch.pipeline import Pipeline
from tpupose_torch.runtime import graphs

torch.set_num_threads(1)
VIEWS = 5
CAPS = {"4/12/24": (4, 12, 24), "16/16/40": (16, 16, 40)}
DISCRETE_STATE = ("active", "confirmed", "track_id", "hits", "time_since_update",
                  "hist_count", "last_n_views", "next_id", "grave_id", "grave_ptr")


def _cfg(caps, **kw):
    d, t, h = caps
    return tt.TrackerConfig(num_cameras=VIEWS, max_dets=d, max_tracks=t, max_hyp=h, **kw)


def _scene(frames, seed=0, views=VIEWS):
    return make_continuous_adversarial_scene(num_frames=frames, num_cameras=views,
                                             num_actors=3, fp_per_view=1, drop_prob=0.2,
                                             seed=seed)


def _inputs(scene, max_dets):
    """(F, C, D, J, 3) detections and (F, C, D) masks, padded (and cut) to
    `max_dets`, and the scene's rig."""
    f, c = scene.num_frames, scene.num_cameras
    dets = np.zeros((f, c, max_dets, 17, 3), np.float32)
    mask = np.zeros((f, c, max_dets), bool)
    for t in range(f):
        for v, d in enumerate(scene.detections_list(t)):
            d = d[:max_dets]
            dets[t, v, :len(d)] = d
            mask[t, v, :len(d)] = True
    cams = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    return torch.as_tensor(dets), torch.as_tensor(mask), cams


def _equal(got, ref, what):
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), f"{what}: {name} differs"


# --------------------------------------------------------------------------
# (a) capturability
# --------------------------------------------------------------------------

class _OpRecorder(TorchDispatchMode):
    """Every op reaching the dispatcher, with its non-tensor arguments and
    its tensors' shapes, dtypes and devices."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, spec = tree_flatten((args, kwargs))
        self.ops.append((str(func), str(spec), tuple(
            (tuple(x.shape), x.dtype, x.device.type) if isinstance(x, torch.Tensor)
            else repr(x) for x in leaves)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("streams", [None, 1, 3], ids=["single", "S1", "S3"])
@pytest.mark.parametrize("caps", sorted(CAPS))
def test_step_issues_the_same_ops_every_frame(caps, streams):
    cfg = _cfg(CAPS[caps])
    frames = 4
    seeds = [0] if streams is None else list(range(streams))
    per = [_inputs(_scene(frames, seed), cfg.max_dets) for seed in seeds]
    if streams is None:
        dets, mask, cams = per[0]
        state = tt.init_state(cfg, "cpu")
        fids = torch.arange(frames, dtype=torch.int32)
        step = tt.tracker_step
    else:
        dets = torch.stack([d for d, _, _ in per], dim=1)  # (F, S, ...)
        mask = torch.stack([m for _, m, _ in per], dim=1)
        cams = CameraSet(*(torch.stack(x) for x in zip(*(c for _, _, c in per))))
        state = init_multistream_state(cfg, streams, "cpu")
        fids = torch.arange(frames, dtype=torch.int32)[:, None].repeat(1, streams)
        step = multistream_step
    assert bool(mask.any(dim=-1).all()) and not bool(mask.all())  # drops and detections
    frame_inputs = [(dets[t].clone(), mask[t].clone(), fids[t].clone()) for t in range(frames)]
    traces = []
    with torch.inference_mode():
        # one step first, as before a capture: the smoothing weights are
        # made once per process (`ops.smoothing._weights`)
        step(cfg, cams, state, *frame_inputs[0])
        for d, m, f in frame_inputs:
            with _OpRecorder() as rec:
                state, out = step(cfg, cams, state, d, m, f)
            traces.append(rec.ops)
    assert int(state.active.sum()) > 0  # tracks were born
    assert len(traces[0]) > 500
    for t in range(1, frames):
        assert len(traces[t]) == len(traces[0]), f"frame {t}: op count differs"
        for k, (a, b) in enumerate(zip(traces[0], traces[t])):
            assert a == b, f"frame {t}, op {k}: {b} differs from frame 0's {a}"


# --------------------------------------------------------------------------
# (b) the buffer logic
# --------------------------------------------------------------------------

def _eager_run(cfg, cams, state, dets, mask, first=0):
    states, outs = [], []
    for t in range(dets.shape[0]):
        state, out = tt.tracker_step(cfg, cams, state, dets[t], mask[t], first + t)
        states.append(state)
        outs.append(out)
    return states, outs


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_step_fn_equals_the_eager_step_bit_for_bit(caps):
    cfg = _cfg(CAPS[caps])
    dets, mask, cams = _inputs(_scene(8, seed=1), cfg.max_dets)
    ref_states, ref_outs = _eager_run(cfg, cams, tt.init_state(cfg, "cpu"), dets, mask)
    step = tt.make_step_fn(cfg)
    state = tt.init_state(cfg, "cpu")
    for t in range(dets.shape[0]):
        state, out = step(cams, state, dets[t], mask[t], t)
        _equal(state, ref_states[t], f"frame {t} state")
        _equal(out, ref_outs[t], f"frame {t} output")
    assert int(ref_outs[-1].valid.sum()) >= 2


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_track_clip_equals_the_eager_steps_bit_for_bit(caps):
    cfg = _cfg(CAPS[caps])
    dets, mask, cams = _inputs(_scene(8, seed=2), cfg.max_dets)
    ref_states, ref_outs = _eager_run(cfg, cams, tt.init_state(cfg, "cpu"), dets, mask,
                                      first=100)
    final, outs = tt.track_clip(cfg, cams, tt.init_state(cfg, "cpu"), dets, mask,
                                torch.arange(100, 108))
    _equal(final, ref_states[-1], "final state")
    _equal(outs, tt.stack_outputs(ref_outs), "stacked outputs")
    assert all(x.is_contiguous() for x in outs)


def test_returned_values_are_the_callers():
    """Later calls leave earlier states and outputs as they were: the
    step hands out copies, never its static buffers."""
    cfg = _cfg(CAPS["4/12/24"])
    dets, mask, cams = _inputs(_scene(6, seed=3), cfg.max_dets)
    step = tt.make_step_fn(cfg)
    state, kept = tt.init_state(cfg, "cpu"), []
    for t in range(6):
        state, out = step(cams, state, dets[t], mask[t], t)
        kept.append((state, out, [x.clone() for x in state], [x.clone() for x in out]))
    for state, out, state_copy, out_copy in kept:
        assert all(torch.equal(a, b) for a, b in zip(state, state_copy))
        assert all(torch.equal(a, b) for a, b in zip(out, out_copy))
    # a clip over the same key leaves them as they were too
    tt.track_clip(cfg, cams, kept[2][0], dets, mask, torch.arange(6, 12))
    state, out, state_copy, out_copy = kept[-1]
    assert all(torch.equal(a, b) for a, b in zip(state, state_copy))


def test_restart_older_state_and_new_cams_take_effect():
    cfg = _cfg(CAPS["4/12/24"])
    dets, mask, cams = _inputs(_scene(6, seed=4), cfg.max_dets)
    step = tt.make_step_fn(cfg)
    states = [tt.init_state(cfg, "cpu")]
    for t in range(4):
        states.append(step(cams, states[-1], dets[t], mask[t], t)[0])
    # an older state, then a restart: each is copied in
    for start in (states[1], tt.init_state(cfg, "cpu")):
        got = step(cams, start, dets[4], mask[4], 4)
        ref = tt.tracker_step(cfg, cams, start, dets[4], mask[4], 4)
        _equal(got[0], ref[0], "state")
        _equal(got[1], ref[1], "output")
    # other cams: other tensors, then those rewritten in place
    other = CameraSet(*(x.clone() for x in cams))
    other.P.mul_(1.01)
    for rig in (other, other):
        got = step(rig, states[4], dets[4], mask[4], 4)
        ref = tt.tracker_step(cfg, rig, states[4], dets[4], mask[4], 4)
        _equal(got[0], ref[0], "state with other cams")
        _equal(got[1], ref[1], "output with other cams")
        other.P.mul_(1.001)
        other.F.mul_(0.999)


def test_pipeline_person_track_and_restart_through_the_step():
    cfg = _cfg(CAPS["4/12/24"])
    dets, mask, cams = _inputs(_scene(6, seed=5), cfg.max_dets)
    pipe = Pipeline(cams, cfg, device="cpu")
    ref_states, ref_outs = _eager_run(cfg, cams, tt.init_state(cfg, "cpu"), dets, mask)
    for round_ in range(2):
        for t in range(6):
            out = pipe.person_track(np.int64(t), dets[t].numpy(), mask[t].numpy())
            _equal(out, ref_outs[t], f"round {round_} frame {t}")
        _equal(pipe.state, ref_states[-1], f"round {round_} state")
        pipe.track_restart()


@pytest.mark.parametrize("frame_id", [3, np.int32(3), torch.tensor(3, dtype=torch.int32),
                                      torch.tensor(3, dtype=torch.int64)],
                         ids=["int", "numpy", "tensor_i32", "tensor_i64"])
def test_frame_id_reaches_the_program_through_its_buffer(frame_id):
    cfg = _cfg(CAPS["4/12/24"])
    dets, mask, cams = _inputs(_scene(2, seed=6), cfg.max_dets)
    state = tt.init_state(cfg, "cpu")
    got = tt.make_step_fn(cfg)(cams, state, dets[0], mask[0], frame_id)
    ref = tt.tracker_step(cfg, cams, state, dets[0], mask[0], 3)
    _equal(got[1], ref[1], "output")
    assert int(got[0].pose2d_time.max()) == 3


@pytest.mark.parametrize("streams", [1, 3])
def test_multistream_step_fn_equals_the_eager_vmapped_step(streams):
    cfg = _cfg(CAPS["4/12/24"])
    per = [_inputs(_scene(5, seed), cfg.max_dets) for seed in range(streams)]
    dets = torch.stack([d for d, _, _ in per], dim=1)
    mask = torch.stack([m for _, m, _ in per], dim=1)
    cams = CameraSet(*(torch.stack(x) for x in zip(*(c for _, _, c in per))))
    step = make_multistream_step_fn(cfg)
    s_ref = s_got = init_multistream_state(cfg, streams, "cpu")
    for t in range(5):
        fids = torch.full((streams,), 10 + t, dtype=torch.int32)
        s_ref, o_ref = multistream_step(cfg, cams, s_ref, dets[t], mask[t], fids)
        s_got, o_got = step(cams, s_got, dets[t], mask[t], fids)
        _equal(s_got, s_ref, f"frame {t} state")
        _equal(o_got, o_ref, f"frame {t} output")


def test_layout_copies_a_whole_tree_at_once():
    cfg = _cfg(CAPS["4/12/24"])
    state = tt.init_state(cfg, "cpu")
    layout = graphs.Layout(state)
    flat = layout.empty((3,))
    rows = layout.views(flat)
    assert [tuple(v.shape) for v in rows] == [(3,) + tuple(x.shape) for x in state]
    assert [v.dtype for v in rows] == [x.dtype for x in state]
    for v, x in zip(rows, state):
        v.copy_(x.expand_as(v))
    other = layout.empty()
    other.copy_(flat[1])
    assert all(torch.equal(a, b) for a, b in zip(layout.views(other), state))
    assert all(off % graphs.ALIGN == 0 for off in layout.offsets)


# --------------------------------------------------------------------------
# (c) parity with the JAX package
# --------------------------------------------------------------------------

PARITY_CAPS = dict(num_cameras=4, max_dets=4, max_tracks=8, max_hyp=16)
PARITY_FRAMES = 12
PARITY_SCENES = {
    "smooth": (lambda: make_scene(num_frames=PARITY_FRAMES, num_cameras=4, num_actors=3,
                                  noise_px=1.0, drop_prob=0.2, seed=11), 5e-3),
    "adversarial": (lambda: _scene(PARITY_FRAMES, seed=12, views=4), 2e-2),
}


@pytest.fixture(scope="module")
def jax_fns():
    jcfg = JConfig(**PARITY_CAPS)

    def clip(rig, st, d, m, f):
        return j_track_clip(jcfg, rig, st, d, m, f)

    return jcfg, j_make_step(jcfg), jax.jit(clip)


def _parity_inputs(name):
    make, tol = PARITY_SCENES[name]
    scene = make()
    dets, mask, _ = _inputs(scene, PARITY_CAPS["max_dets"])
    rig = j_make_cams(scene.P, scene.K, scene.RT, scene.width, scene.height)
    cams = CameraSet(*(torch.as_tensor(np.array(x)) for x in rig))
    return rig, cams, dets, mask, tol


def _held_to_jax(state, out, js, jo, tol, what):
    for field in ("track_id", "valid", "n_views", "pose2d_now"):
        np.testing.assert_array_equal(getattr(out, field).numpy(),
                                      np.asarray(getattr(jo, field)), err_msg=f"{what} {field}")
    for field in DISCRETE_STATE:
        np.testing.assert_array_equal(getattr(state, field).numpy(),
                                      np.asarray(getattr(js, field)), err_msg=f"{what} {field}")
    valid = out.valid.numpy()
    np.testing.assert_allclose(out.pose3d.numpy()[valid], np.asarray(jo.pose3d)[valid],
                               atol=tol, err_msg=f"{what} pose3d")


@pytest.mark.parametrize("name", sorted(PARITY_SCENES))
def test_step_fn_matches_jax_make_step_fn(name, jax_fns):
    jcfg, j_step, _ = jax_fns
    rig, cams, dets, mask, tol = _parity_inputs(name)
    cfg = tt.TrackerConfig(**PARITY_CAPS)
    step = tt.make_step_fn(cfg)
    js, ts, confirmed = j_init(jcfg), tt.init_state(cfg, "cpu"), 0
    for t in range(PARITY_FRAMES):
        js, jo = j_step(rig, js, jnp.asarray(dets[t].numpy()), jnp.asarray(mask[t].numpy()), t)
        ts, to = step(cams, ts, dets[t], mask[t], t)
        _held_to_jax(ts, to, js, jo, tol, f"frame {t}")
        confirmed = max(confirmed, int(to.valid.sum()))
    assert confirmed >= 2


@pytest.mark.parametrize("name", sorted(PARITY_SCENES))
def test_track_clip_matches_jax_track_clip(name, jax_fns):
    jcfg, _, j_clip = jax_fns
    rig, cams, dets, mask, tol = _parity_inputs(name)
    cfg = tt.TrackerConfig(**PARITY_CAPS)
    fids = np.arange(PARITY_FRAMES, dtype=np.int32)
    js, jo = j_clip(rig, j_init(jcfg), jnp.asarray(dets.numpy()), jnp.asarray(mask.numpy()),
                    jnp.asarray(fids))
    ts, to = tt.track_clip(cfg, cams, tt.init_state(cfg, "cpu"), dets, mask,
                           torch.as_tensor(fids))
    _held_to_jax(ts, type(to)(*(x[-1] for x in to)), js,
                 type(jo)(*(x[-1] for x in jo)), tol, "last frame")
    for field in ("track_id", "valid", "n_views", "pose2d_now"):
        np.testing.assert_array_equal(getattr(to, field).numpy(),
                                      np.asarray(getattr(jo, field)), err_msg=field)


# --------------------------------------------------------------------------
# (d) launch counters under simulated replays
# --------------------------------------------------------------------------

class _SimulatedGraph:
    """A CUDA graph's bookkeeping without a card: the warm-up runs, the
    capture runs the body once (as a capture calls every wrapper once,
    launching nothing), and a replay runs nothing on the host."""

    def __init__(self):
        self.replayed = 0

    def node_counts(self):
        return None

    def warmup(self, fn, n):
        for _ in range(n):
            out = fn()
        return out

    def capture(self, body):
        body()

    def replay(self):
        self.replayed += 1


@pytest.fixture
def counted_plain_lap(monkeypatch):
    """The plain LAP counted as K3's wrapper counts its launches."""
    plain = lap.masked_lap_plain

    def counted(*args, **kw):
        lap.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(lap, "masked_lap_plain", counted)
    monkeypatch.setattr(lap, "launches", 0)


@pytest.mark.parametrize("streams", [None, 3], ids=["single", "S3"])
def test_counters_count_replays_not_the_capture(streams, counted_plain_lap):
    cfg = _cfg(CAPS["4/12/24"])
    dets, mask, cams = _inputs(_scene(2, seed=7), cfg.max_dets)
    if streams is None:
        fn, state, fid = (lambda *a: tt.tracker_step(cfg, *a)), tt.init_state(cfg, "cpu"), 0
    else:
        fn = (lambda *a: multistream_step(cfg, *a))
        state, cams = init_multistream_state(cfg, streams, "cpu"), broadcast_cameras(cams, streams)
        dets, mask = (x[:, None].expand((-1, streams) + x.shape[1:]) for x in (dets, mask))
        fid = torch.zeros(streams, dtype=torch.int32)
    program = _SimulatedGraph()
    step = graphs.CapturedStep(fn, cams, state, dets[0], mask[0], fid, program=program)
    per_call = 1 + VIEWS  # one association LAP, one init LAP a camera, at any S
    assert step.held_launches == [per_call]
    assert step.warmup_launches == [graphs.WARMUP * per_call]
    assert lap.launches == graphs.WARMUP * per_call  # the capture's are taken back
    for k in range(1, 4):
        state, _ = step.step(cams, state, dets[1], mask[1], fid)
        assert lap.launches == (graphs.WARMUP + k) * per_call
    assert program.replayed == step.replays == 3
    assert step.stats()["replays"] == 3
    assert step.stats()["held_launches"] == {"lap.launches": per_call}


def test_counters_on_the_cpu_count_each_run(counted_plain_lap):
    """On the CPU nothing is captured: each replay runs the step, which
    counts its own calls."""
    cfg = _cfg(CAPS["4/12/24"])
    dets, mask, cams = _inputs(_scene(2, seed=8), cfg.max_dets)
    state = tt.init_state(cfg, "cpu")
    step = graphs.CapturedStep(lambda *a: tt.tracker_step(cfg, *a), cams, state, dets[0],
                               mask[0], 0)
    assert step.held_launches == [0] and step.warmup_launches == [1 + VIEWS]
    step.step(cams, state, dets[1], mask[1], 1)
    assert lap.launches == 2 * (1 + VIEWS)
