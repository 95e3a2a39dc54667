"""The port's registries (`utils/registry`, `pipeline/registry_defs`),
validators (`utils/validate`), limb tables (`utils/limbs`) and the geometry
hooks `CameraSet.undistort` / `undistort_points`, `load_calibration_pickle`
and `epipolar_distance_pair`, each against its JAX counterpart.

Tolerances and why:
* Registry names, limb tables and masks, the calibration arrays and the
  tracker configs are equal: they are copies of the same values.
* Bone lengths within 1e-6 (f32 norms, numpy on one side, XLA on the
  other); epipolar distances within rtol 1e-4 / atol 1e-3 px, the band of
  tests/test_torch_geometry.py (f32 products in another order).
* The validators decide as the JAX package's do on the same states and
  outputs, the JAX tracker invariants run on the port's states.
"""
import dataclasses
import os
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpupose.geometry as jg
import tpupose.pipeline.registry_defs  # noqa: F401  (fills the JAX registries)
import tpupose.utils.limbs as jlimbs
import tpupose.utils.registry as jreg
import tpupose.utils.validate as jval
import tpupose_torch.geometry as tg
import tpupose_torch.pipeline.registry_defs as tdefs
import tpupose_torch.utils.limbs as tlimbs
import tpupose_torch.utils.registry as treg
import tpupose_torch.utils.validate as tval

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTRIES = ("DETECTORS", "POSE_MODELS", "MATCHERS", "TEST_FUNCTIONS", "INIT_METHODS",
              "BUILD_3D_KERNELS")
#: Names the port registers that the JAX package has no counterpart of.
PORT_ONLY = {"POSE_MODELS": ["vitpose"]}


@pytest.mark.parametrize("name", REGISTRIES)
def test_registries_hold_jax_names(name):
    got, ref = getattr(treg, name), getattr(jreg, name)
    own = PORT_ONLY.get(name, [])
    assert got.kind == ref.kind and got.names() == sorted(ref.names() + own) and got.names()
    for key in got.names():
        assert callable(got.get(key.upper()))
    with pytest.raises(KeyError, match="available"):
        got.get("nonexistent")
    with pytest.raises(KeyError, match="already registered"):
        got.register(got.names()[0])(lambda: None)


def test_registry_factories_build_port_modules(tmp_path):
    from tpupose.data.config import load_config as j_load_config
    from tpupose_torch.data.config import DetectModelConfig, PoseModelConfig, load_config
    from tpupose_torch.models.hrnet import HRNetConfig, hrnet_init

    assert treg.BUILD_3D_KERNELS.get("svd")() is tg.triangulate_joints
    assert treg.BUILD_3D_KERNELS.get("TopDown")() is tg.triangulate_top_down
    for method in ("gd", "bip"):
        assert treg.INIT_METHODS.get(method)() == jreg.INIT_METHODS.get(method)() == method
    assert treg.DETECTORS.get("none")(DetectModelConfig()) == (None, None)
    with pytest.raises(NotImplementedError):
        treg.TEST_FUNCTIONS.get("PersonTrack_Project3DPose")(None, None)
    yaml_path = os.path.join(ROOT, "configs", "Shelf", "model_configs.yaml")
    got = treg.MATCHERS.get("iterative")(load_config(yaml_path), 5)
    ref = jreg.MATCHERS.get("iterative")(j_load_config(yaml_path), 5)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)

    # hrpose: an HRNet of the config's width from a .pth, as the JAX factory
    # builds it (full depth at width 8 keeps the file small)
    pth = tmp_path / "pose.pth"
    torch.save(hrnet_init(HRNetConfig(width=8), torch.Generator().manual_seed(0)).state_dict(),
               pth)
    pose_cfg, model = treg.POSE_MODELS.get("HRPose")(PoseModelConfig(c=8, checkpoint_file=str(pth)))
    j_cfg, j_params = jreg.POSE_MODELS.get("hrpose")(PoseModelConfig(c=8, checkpoint_file=str(pth)))
    assert (pose_cfg.width, pose_cfg.num_joints, pose_cfg.input_size) == \
        (j_cfg.width, j_cfg.num_joints, j_cfg.input_size)
    from tpupose_torch.models.convert import state_dict_from_jax

    ref_sd = state_dict_from_jax(j_params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref_sd[k]), k
    assert tdefs.build_hrpose is treg.POSE_MODELS.get("hrpose")


def test_checked_finite_raises_on_planted_nan():
    def step(x):
        return {"y": x * 2, "n": torch.arange(3)}, (x / (x - x),)

    with pytest.raises(FloatingPointError, match="non-finite"):
        tval.checked_finite(step)(torch.ones(3))
    err, _ = jval.checked_finite(lambda x: x / (x - x))(jnp.ones(3))
    with pytest.raises(Exception):
        err.throw()

    out = tval.checked_finite(lambda x: (x * 2, [torch.tensor([1, 2])]))(torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    x = torch.ones(3)
    x[1] = float("inf")
    with pytest.raises(FloatingPointError):
        tval.checked_finite(lambda v: v.to(torch.bfloat16))(x)


def test_tracker_invariants_over_replay():
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.tracking.tracker import TrackerConfig, init_state, tracker_step

    scene = make_scene(num_frames=15, num_cameras=4, num_actors=2, noise_px=1.0,
                       drop_prob=0.2, seed=9)
    rig = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    cfg = TrackerConfig(num_cameras=4, max_dets=6, max_tracks=8, max_hyp=16)
    state = init_state(cfg, "cpu")
    with torch.inference_mode():
        for t in range(scene.num_frames):
            dets = np.zeros((4, 6, 17, 3), np.float32)
            mask = np.zeros((4, 6), bool)
            for c, d in enumerate(scene.detections_list(t)):
                dets[c, : len(d)] = d
                mask[c, : len(d)] = True
            state, _ = tracker_step(cfg, rig, state, torch.as_tensor(dets),
                                    torch.as_tensor(mask), t)
            tval.assert_tracker_invariants(state, cfg)
            jval.assert_tracker_invariants(state, cfg)
    assert bool(state.confirmed.any())
    # a duplicated live id fails both
    slots = torch.nonzero(state.active).flatten()
    assert slots.numel() >= 2
    ids = state.track_id.clone()
    ids[slots[1]] = ids[slots[0]]
    broken = state._replace(track_id=ids)
    with pytest.raises(AssertionError, match="duplicate track ids"):
        tval.assert_tracker_invariants(broken, cfg)
    with pytest.raises(AssertionError, match="duplicate track ids"):
        jval.assert_tracker_invariants(broken, cfg)


def test_limbs_match_jax():
    for name in ("JOINT_NAMES", "JOINT_TO_GT_JOINT", "SYMMETRIC_JOINTS",
                 "SENSIBLE_LIMB_LENGTH", "COCO_BONES"):
        np.testing.assert_array_equal(np.asarray(getattr(tlimbs, name)),
                                      np.asarray(getattr(jlimbs, name)), err_msg=name)
    rng = np.random.default_rng(7)
    masks = set()
    for _ in range(50):
        pose = rng.normal(scale=0.35, size=(18, 3))
        got = tlimbs.correct_limbs_mask(pose)
        np.testing.assert_array_equal(got, jlimbs.correct_limbs_mask(pose))
        masks.add(got.tobytes())
        assert tlimbs.limb_length_ok(pose[0], pose[1], 0, 2.0) == \
            jlimbs.limb_length_ok(pose[0], pose[1], 0, 2.0)
    assert len(masks) > 3  # the poses reach several branches of the cascade
    pose17 = rng.normal(size=(17, 3)).astype(np.float32)
    np.testing.assert_allclose(tlimbs.coco_bone_lengths(pose17),
                               np.asarray(jlimbs.coco_bone_lengths(pose17)), rtol=1e-6)


def _rigs():
    from tpupose.data.synthetic import make_scene

    scene = make_scene(num_frames=2, num_cameras=4, num_actors=2, seed=3)
    return (scene, tg.make_camera_set(scene.P, scene.K, scene.RT, 1280, 720),
            jg.make_camera_set(scene.P, scene.K, scene.RT, 1280, 720))


def test_load_calibration_pickle_matches_jax(tmp_path):
    from tpupose.geometry.cameras import load_calibration_pickle as j_load

    scene, _, _ = _rigs()
    path = tmp_path / "camera_parameter.pickle"
    with open(path, "wb") as f:
        pickle.dump({"P": scene.P.astype(np.float64), "K": scene.K, "RT": scene.RT}, f)
    for n in (None, 3):
        for got, ref in zip(tg.load_calibration_pickle(str(path), n), j_load(str(path), n)):
            assert got.dtype == ref.dtype == np.float32 and got.shape[0] == (n or 4)
            np.testing.assert_array_equal(got, ref)


def test_undistort_hooks_are_no_ops_as_in_jax():
    _, trig, jrig = _rigs()
    images = torch.zeros((4, 8, 8, 3), dtype=torch.uint8)
    pts = torch.ones((4, 17, 3))
    assert trig.undistort(images) is images and trig.undistort_points(pts) is pts
    assert jrig.undistort(images) is images and jrig.undistort_points(pts) is pts


def test_epipolar_distance_pair_matches_jax():
    from tpupose.geometry.epipolar import epipolar_distance_pair as j_pair

    _, trig, jrig = _rigs()
    rng = np.random.default_rng(2)
    a = rng.uniform(100, 1000, size=(17, 3)).astype(np.float32)
    b = rng.uniform(100, 1000, size=(17, 3)).astype(np.float32)
    for i, j in ((0, 1), (2, 3), (3, 0)):
        got = tg.epipolar_distance_pair(trig.F[i, j], torch.as_tensor(a), torch.as_tensor(b))
        ref = j_pair(jrig.F[i, j], jnp.asarray(a), jnp.asarray(b))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-3)
        # the second distance is the directed one
        torch.testing.assert_close(got[1], tg.epipolar_distance_directed(
            trig.F[i, j], torch.as_tensor(a), torch.as_tensor(b)), rtol=0, atol=0)
