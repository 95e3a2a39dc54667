"""The port's f64 oracle tracker (`tpupose_torch.tracking.oracle`) against
the JAX package's, and the port's tracker against the port's oracle, on
the three scenes of tests/test_tracker_parity.py.

* Oracle against oracle: the same numpy f64 and scipy code on the same
  detections and the same camera arrays, so every decision, pose and
  output is exactly equal.
* Tracker against oracle: tests/test_tracker_parity.py's rule. Track ids,
  states, hits and time since update equal at every frame, the last pose
  of each track within 5e-3 m (an f32 tracker against an f64 spec), and
  the same ids in the frame's outputs.
"""
import numpy as np
import pytest
import torch

from tpupose.data.synthetic import make_scene
from tpupose.geometry import make_camera_set as j_make_camera_set
from tpupose.tracking import oracle as joracle
import tpupose_torch.tracking.tracker as tt
from tpupose_torch.data.synthetic import make_scene as t_make_scene
from tpupose_torch.geometry import make_camera_set
from tpupose_torch.tracking import oracle as toracle

torch.set_num_threads(1)

SCENES = [
    dict(num_frames=25, num_cameras=4, num_actors=2, noise_px=0.8, seed=1),
    dict(num_frames=30, num_cameras=5, num_actors=3, noise_px=1.2, drop_prob=0.2, seed=2),
    dict(num_frames=25, num_cameras=3, num_actors=2, noise_px=1.5, drop_prob=0.3, seed=3),
]


def _np_cams(module, rig):
    return module.OracleTracker.make_cameras(*(np.asarray(getattr(rig, f))
                                               for f in ("P", "F", "rk_inv", "center")))


def _summary(oracle):
    return {t.track_id: (t.state, t.hits, t.time_since_update, t.history[-1][1])
            for t in oracle.tracks}


def _state_summary(state):
    out = {}
    for i in torch.nonzero(state.active).flatten().tolist():
        st = toracle.CONFIRMED if bool(state.confirmed[i]) else toracle.TENTATIVE
        count = int(state.hist_count[i])
        out[int(state.track_id[i])] = (st, int(state.hits[i]), int(state.time_since_update[i]),
                                       state.hist_pose[i, count - 1].numpy())
    return out


@pytest.mark.parametrize("scene_kw", SCENES, ids=["4cam", "5cam_drops", "3cam_drops"])
def test_oracle_equals_jax_oracle(scene_kw):
    scene = make_scene(**scene_kw)
    rig = j_make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    ref = joracle.OracleTracker(_np_cams(joracle, rig), joracle.TrackerParams())
    got = toracle.OracleTracker(_np_cams(toracle, rig), toracle.TrackerParams())
    assert toracle.TrackerParams() == toracle.TrackerParams(**vars(joracle.TrackerParams()))
    confirmed = 0
    for t in range(scene.num_frames):
        ref.step(t, scene.detections_list(t))
        got.step(t, scene.detections_list(t))
        r, g = _summary(ref), _summary(got)
        assert set(r) == set(g), f"frame {t}"
        for tid in r:
            assert r[tid][:3] == g[tid][:3], f"frame {t} track {tid}"
            np.testing.assert_array_equal(g[tid][3], r[tid][3])
        for a, b in zip(got.tracks, ref.tracks):
            np.testing.assert_array_equal(a.velocity, b.velocity)
            np.testing.assert_array_equal(a.last_n_views, b.last_n_views)
        r_out, g_out = ref.outputs(t), got.outputs(t)
        assert [o["id"] for o in g_out] == [o["id"] for o in r_out]
        for a, b in zip(g_out, r_out):
            np.testing.assert_array_equal(a["pose3d"], b["pose3d"])
            assert sorted(a["poses2d"]) == sorted(b["poses2d"])
        confirmed = max(confirmed, len(g_out))
    assert confirmed >= 2


@pytest.mark.parametrize("scene_kw", SCENES, ids=["4cam", "5cam_drops", "3cam_drops"])
def test_tracker_matches_port_oracle(scene_kw):
    scene = t_make_scene(**scene_kw)
    cams = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    oracle = toracle.OracleTracker(_np_cams(toracle, cams), toracle.TrackerParams())
    D = scene.num_actors
    cfg = tt.TrackerConfig(num_cameras=scene.num_cameras, max_dets=D, max_tracks=8,
                           max_hyp=16)
    state = tt.init_state(cfg, "cpu")
    for t in range(scene.num_frames):
        oracle.step(t, scene.detections_list(t))
        dets = np.zeros((scene.num_cameras, D, 17, 3), np.float32)
        mask = np.zeros((scene.num_cameras, D), bool)
        for c, d in enumerate(scene.detections_list(t)):
            dets[c, :len(d)] = d
            mask[c, :len(d)] = True
        state, out = tt.tracker_step(cfg, cams, state, torch.as_tensor(dets),
                                     torch.as_tensor(mask), t)
        ref, got = _summary(oracle), _state_summary(state)
        assert set(ref) == set(got), f"frame {t}: ids ref={set(ref)} got={set(got)}"
        for tid in ref:
            assert ref[tid][:3] == got[tid][:3], f"frame {t} track {tid}"
            err = np.abs(ref[tid][3] - got[tid][3]).max()
            assert err < 5e-3, f"frame {t} track {tid}: pose err {err}"
        got_ids = set(out.track_id[out.valid].tolist())
        assert got_ids == {o["id"] for o in oracle.outputs(t)}, f"frame {t}"
