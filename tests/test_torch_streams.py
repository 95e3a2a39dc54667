"""The port's multi-stream tracker (`tpupose_torch.parallel.streams`)
against the JAX package's `make_multistream_step_fn` (no mesh) and against
its own single-stream step.

S = 4 streams of different scenes advance together. Against JAX, discrete
state is exactly equal at every step and pose3d lies within
tests/test_torch_tracker.py's bands (5e-3 m on smooth scenes, 2e-2 m on the
adversarial ones: XLA and torch sum in different orders). Against the
port's own single-stream `tracker_step` on each scene, discrete state is
exactly equal and pose3d within 1e-5 m: the batched step runs the same ops,
but a batched reduction may sum in another order.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.geometry import make_camera_set as j_make_cams
from tpupose.parallel.streams import broadcast_cameras as j_broadcast
from tpupose.parallel.streams import init_multistream_state as j_init_ms
from tpupose.parallel.streams import make_multistream_step_fn as j_make_step
from tpupose.tracking.tracker import TrackerConfig as JConfig
import tpupose_torch.tracking.tracker as tt
from tpupose_torch.data.synthetic import make_continuous_adversarial_scene, make_scene
from tpupose_torch.geometry import CameraSet, make_camera_set
from tpupose_torch.parallel import (
    broadcast_cameras,
    init_multistream_state,
    make_multistream_step_fn,
    multistream_step,
    shard_streams,
)
from tpupose_torch.parallel.mesh import Mesh

torch.set_num_threads(1)
S, C, D, FRAMES = 4, 4, 4, 12
CAPS = dict(num_cameras=C, max_dets=D, max_tracks=8, max_hyp=16,
            resurrect_window=20, max_age=4)
SCENES = {
    "smooth": (lambda s: make_scene(num_frames=FRAMES, num_cameras=C, num_actors=3,
                                    noise_px=1.0, drop_prob=0.2, seed=10 + s), 5e-3),
    "adversarial": (lambda s: make_continuous_adversarial_scene(
        num_frames=FRAMES, num_cameras=C, num_actors=3, fp_per_view=1, drop_prob=0.2,
        seed=s), 2e-2),
}
DISCRETE_STATE = ("active", "confirmed", "track_id", "hits", "time_since_update",
                  "hist_count", "last_n_views", "next_id", "grave_id", "grave_ptr")


@pytest.fixture(scope="module")
def jax_step():
    return j_make_step(JConfig(**CAPS))


def _padded(scene, t):
    dets = np.zeros((C, D, 17, 3), np.float32)
    mask = np.zeros((C, D), bool)
    for c, d in enumerate(scene.detections_list(t)):
        dets[c, :len(d)] = d
        mask[c, :len(d)] = True
    return dets, mask


@pytest.mark.parametrize("name", sorted(SCENES))
def test_multistream_step_matches_jax_and_single_streams(name, jax_step):
    make, pose_tol = SCENES[name]
    scenes = [make(s) for s in range(S)]
    rigs = [j_make_cams(sc.P, sc.K, sc.RT, sc.width, sc.height) for sc in scenes]
    j_cams = jax.tree.map(lambda *x: jnp.stack(x), *rigs)
    cams = CameraSet(*(torch.as_tensor(np.array(x)) for x in j_cams))
    one_cams = [CameraSet(*(x[s] for x in cams)) for s in range(S)]
    cfg = tt.TrackerConfig(**CAPS)
    js, ts = j_init_ms(JConfig(**CAPS), S), init_multistream_state(cfg, S, "cpu")
    singles = [tt.init_state(cfg, "cpu") for _ in range(S)]
    confirmed = 0
    for t in range(FRAMES):
        frames = [_padded(sc, t) for sc in scenes]
        dets = np.stack([d for d, _ in frames])
        mask = np.stack([m for _, m in frames])
        fids = np.full(S, t, np.int32)
        js, jo = jax_step(j_cams, js, jnp.asarray(dets), jnp.asarray(mask), jnp.asarray(fids))
        ts, to = multistream_step(cfg, cams, ts, torch.as_tensor(dets),
                                  torch.as_tensor(mask), torch.as_tensor(fids))
        for field in ("track_id", "valid", "n_views", "pose2d_now"):
            np.testing.assert_array_equal(getattr(to, field).numpy(),
                                          np.asarray(getattr(jo, field)),
                                          err_msg=f"frame {t} {field}")
        for field in DISCRETE_STATE:
            np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                          np.asarray(getattr(js, field)),
                                          err_msg=f"frame {t} {field}")
        valid = to.valid.numpy()
        np.testing.assert_allclose(to.pose3d.numpy()[valid], np.asarray(jo.pose3d)[valid],
                                   atol=pose_tol, err_msg=f"frame {t} pose3d")
        for s in range(S):
            singles[s], o = tt.tracker_step(cfg, one_cams[s], singles[s],
                                            torch.as_tensor(dets[s]),
                                            torch.as_tensor(mask[s]), t)
            for field in DISCRETE_STATE:
                torch.testing.assert_close(getattr(ts, field)[s], getattr(singles[s], field),
                                           rtol=0, atol=0)
            torch.testing.assert_close(to.pose3d[s], o.pose3d, rtol=0, atol=1e-5)
            torch.testing.assert_close(to.pose2d[s], o.pose2d, rtol=0, atol=0)
        confirmed = max(confirmed, int(valid.sum()))
    assert confirmed >= 2 * S  # every stream really tracks


def test_broadcast_and_init_give_every_stream_its_own_copy():
    scene = make_scene(num_frames=1, num_cameras=C, seed=0)
    cams = make_camera_set(scene.P, scene.K, scene.RT, 1280, 720)
    cams_s = broadcast_cameras(cams, 3)
    assert all(x.shape == (3,) + y.shape for x, y in zip(cams_s, cams))
    state = init_multistream_state(tt.TrackerConfig(**CAPS), 3, "cpu")
    assert state.next_id.shape == (3,) and state.pose2d.shape == (3, 8, C, 17, 3)
    state.next_id[0] = 5
    assert state.next_id.tolist() == [5, 0, 0]
    j_state = j_init_ms(JConfig(**CAPS), 3)
    for a, b in zip(state, j_state):
        assert tuple(a.shape) == tuple(b.shape)
    for a, b in zip(cams_s, cams):
        assert torch.equal(a[2], b)
    j_cams = j_broadcast(j_make_cams(scene.P, scene.K, scene.RT, 1280, 720), 3)
    assert [tuple(x.shape) for x in cams_s] == [tuple(x.shape) for x in j_cams]


def test_step_fn_refuses_a_mesh_and_state_defaults_to_cuda():
    """With a mesh, the step runs this rank's shard of the streams (here
    the second of two 'data' ranks, a mesh built without a process group)
    and refuses inputs that are not that shard, or a mesh without the
    global stream count."""
    cfg = tt.TrackerConfig(**CAPS)
    mesh = Mesh(None, {"data": 2, "model": 1}, None, None, 1, 0, torch.device("cpu"))
    with pytest.raises(TypeError, match="num_streams"):
        make_multistream_step_fn(cfg, mesh)
    scenes = [SCENES["smooth"][0](s) for s in range(S)]
    cams = CameraSet(*(torch.stack(x) for x in zip(*(
        make_camera_set(sc.P, sc.K, sc.RT, sc.width, sc.height) for sc in scenes))))
    frames = [_padded(sc, 0) for sc in scenes]
    inputs = (cams, init_multistream_state(cfg, S, "cpu"),
              torch.as_tensor(np.stack([d for d, _ in frames])),
              torch.as_tensor(np.stack([m for _, m in frames])), torch.zeros(S, dtype=torch.int32))
    step = make_multistream_step_fn(cfg, mesh, num_streams=S)
    local_state, local_out = step(*shard_streams(mesh, inputs))
    whole_state, whole_out = multistream_step(cfg, *inputs)
    # without a mesh the step is the captured multistream_step (on the CPU,
    # its buffers over the eager step): the same values, bit for bit
    for got, ref in zip(make_multistream_step_fn(cfg)(*inputs), (whole_state, whole_out)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    for got, ref in zip(tuple(local_state) + tuple(local_out),
                        tuple(whole_state) + tuple(whole_out)):
        torch.testing.assert_close(got, ref[S // 2:], rtol=0, atol=1e-5)
    assert local_state.active.shape == (S // 2, CAPS["max_tracks"])
    with pytest.raises(ValueError, match=r"cams\.P has leading size \(4,\)"):
        step(*inputs)
    with pytest.raises(ValueError, match="frame_ids has leading size"):
        step(*shard_streams(mesh, inputs[:4]), torch.zeros(S, dtype=torch.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_multistream_state(cfg, 2)
