"""The port's tracker against the JAX tracker, step by step, on the same
detections (made by the JAX package's scene generators) and the same
camera arrays.

Discrete state must be exactly equal at every step: track ids, validity,
activity, confirmation, hits, time since update, history length, views
per joint. pose3d agrees within the band the JAX package allows between
its f32 tracker and its f64 oracle, 5e-3 m (tests/test_tracker_parity.py),
on the smooth scenes: both trackers run the same f32 algorithm, but XLA
and torch sum in different orders, the smallest-eigenvector solve
amplifies that rounding (see test_torch_geometry.py), and history
smoothing and velocity carry it from frame to frame. The adversarial
scenes (stale views, occlusion, false positives) are worse conditioned:
there the JAX tracker itself lies up to 13.6 mm from the f64 oracle, and
the port as far, so they get 2e-2 m.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpupose.data.synthetic import make_continuous_adversarial_scene, make_scene
from tpupose.geometry import make_camera_set
import tpupose.tracking.tracker as jtr
from tpupose.tracking.tracker import TrackerConfig as JConfig
from tpupose.tracking.tracker import init_state as j_init
from tpupose.tracking.tracker import make_step_fn
import tpupose_torch.tracking.tracker as tt
from tpupose_torch.data.synthetic import make_scene as t_make_scene
from tpupose_torch.geometry import CameraSet

torch.set_num_threads(1)

# name: (scene, tracker options, pose3d tolerance in metres)
SCENES = {
    "scene_4cam": (lambda: make_scene(num_frames=25, num_cameras=4, num_actors=2,
                                      noise_px=0.8, seed=1), {}, 5e-3),
    "scene_5cam_drops": (lambda: make_scene(num_frames=30, num_cameras=5, num_actors=3,
                                            noise_px=1.2, drop_prob=0.2, seed=2),
                         {}, 5e-3),
    "adversarial_fp": (lambda: make_continuous_adversarial_scene(
        num_frames=40, num_cameras=5, num_actors=3, fp_per_view=1, drop_prob=0.1,
        seed=0), {}, 2e-2),
    "adversarial_resurrect": (lambda: make_continuous_adversarial_scene(
        num_frames=40, num_cameras=4, num_actors=3, drop_prob=0.3, seed=4),
        dict(resurrect_window=20, max_age=4), 2e-2),
}


def _padded(scene, t, D):
    C = scene.num_cameras
    dets = np.zeros((C, D, 17, 3), np.float32)
    mask = np.zeros((C, D), bool)
    for c, d in enumerate(scene.detections_list(t)):
        dets[c, :len(d)] = d
        mask[c, :len(d)] = True
    return dets, mask


def _cams_from_jax(rig):
    return CameraSet(*(torch.as_tensor(np.array(x)) for x in rig))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tracker_step_matches_jax(name):
    make, kw, pose_tol = SCENES[name]
    scene = make()
    D = scene.detections.shape[2]
    jcfg = JConfig(num_cameras=scene.num_cameras, max_dets=D, max_tracks=8,
                   max_hyp=16, **kw)
    tcfg = tt.TrackerConfig(num_cameras=scene.num_cameras, max_dets=D,
                            max_tracks=8, max_hyp=16, **kw)
    rig = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    cams = _cams_from_jax(rig)
    step = make_step_fn(jcfg)
    js, ts = j_init(jcfg), tt.init_state(tcfg, "cpu")
    n_confirmed = 0
    for t in range(scene.num_frames):
        dets, mask = _padded(scene, t, D)
        js, jo = step(rig, js, jnp.asarray(dets), jnp.asarray(mask), t)
        ts, to = tt.tracker_step(tcfg, cams, ts, torch.as_tensor(dets),
                                 torch.as_tensor(mask), t)
        for field in ("track_id", "valid", "n_views", "pose2d_now"):
            np.testing.assert_array_equal(getattr(to, field).numpy(),
                                          np.asarray(getattr(jo, field)),
                                          err_msg=f"frame {t} {field}")
        for field in ("active", "confirmed", "hits", "time_since_update",
                      "hist_count", "next_id", "grave_id", "grave_ptr"):
            np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                          np.asarray(getattr(js, field)),
                                          err_msg=f"frame {t} {field}")
        valid = to.valid.numpy()
        np.testing.assert_allclose(to.pose3d.numpy()[valid],
                                   np.asarray(jo.pose3d)[valid], atol=pose_tol,
                                   err_msg=f"frame {t} pose3d")
        np.testing.assert_array_equal(to.pose2d.numpy(), np.asarray(jo.pose2d))
        n_confirmed = max(n_confirmed, int(valid.sum()))
    assert n_confirmed >= 2  # the scenes really exercise tracking


def test_track_clip_equals_steps_and_port_scene_equals_jax_scene():
    kw = dict(num_frames=12, num_cameras=3, num_actors=2, noise_px=1.0, seed=5)
    scene, port_scene = make_scene(**kw), t_make_scene(**kw)
    for field in ("P", "K", "RT", "gt3d", "detections", "visible"):
        np.testing.assert_array_equal(getattr(port_scene, field), getattr(scene, field))
    cfg = tt.TrackerConfig(num_cameras=3, max_dets=2, max_tracks=6, max_hyp=8)
    cams = _cams_from_jax(make_camera_set(scene.P, scene.K, scene.RT, 1280, 720))
    frames = [_padded(scene, t, 2) for t in range(12)]
    state, outs = tt.init_state(cfg, "cpu"), []
    for t, (d, m) in enumerate(frames):
        state, o = tt.tracker_step(cfg, cams, state, torch.as_tensor(d), torch.as_tensor(m), t)
        outs.append(o)
    final, stacked = tt.track_clip(
        cfg, cams, tt.init_state(cfg, "cpu"),
        torch.as_tensor(np.stack([d for d, _ in frames])),
        torch.as_tensor(np.stack([m for _, m in frames])),
        torch.arange(12, dtype=torch.int32))
    for a, b in zip(tt.stack_outputs(outs), stacked):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(final.hist_pose, state.hist_pose, rtol=0, atol=0)
    assert stacked.valid[-1].sum() == 2


def test_init_state_defaults_to_cuda_and_gates_equal_jax():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.init_state(tt.TrackerConfig(num_cameras=3))
    assert (tt.REFERENCE_JOINT_GATE, tt.CAMPUS_JOINT_GATE) == (
        jtr.REFERENCE_JOINT_GATE, jtr.CAMPUS_JOINT_GATE) == (10, 14)
    assert tt.TrackerConfig(num_cameras=3).joint_gate == JConfig(num_cameras=3).joint_gate
