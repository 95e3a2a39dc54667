"""The end-to-end PCP chain `tpupose_torch.eval.e2e` against
`tpupose.eval.e2e`: scene crops, the HRNet-then-decode pass and the
tracker-to-PCP scoring, on the tiny HRNet, on the CPU.

Tolerances and why:
* `render_blob_crop` and `image_to_crop`: exactly equal (the same numpy
  arithmetic).
* `crop_boxes_for_scene` and `build_scene_crops`: within 1e-6 (the box
  expansion is f32 torch against f32 XLA, the crops then render at those
  boxes).
* `decode_tree`: equal to the port's own bf16 forward-then-decode on the
  same raw [0, 1] crops (no ImageNet normalization: the mirror of
  tests/test_int8_e2e_pcp.py's pin); that forward-then-decode in f32
  against the JAX forward and decode on the same crops: coordinates within
  1e-3 px (measured
  equal: no argmax moves), scores within rtol 1e-5 and 1e-5 of the
  largest score (measured 1.2e-6 of it; f32 convolutions summed in another
  order).
* `pcp_through_tracker`: the same PCP table and per-frame checks as JAX's,
  with perfect detections and with the outlier pattern of
  tests/test_int8_e2e_pcp.py (5% of one camera's joints moved 75 px).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.eval.e2e as je
from tpupose.data.synthetic import make_scene as j_make_scene
from tpupose.models.hrnet import hrnet_apply, tiny_test_config
from tpupose.models.train import JOINT_COLORS
from tpupose.ops.heatmap import decode_heatmaps as j_decode
import tpupose_torch.eval.e2e as te
import tpupose_torch.models.hrnet as th
from tpupose_torch.data.synthetic import make_scene
from tpupose_torch.ops.heatmap import decode_heatmaps
from tests.test_torch_train import _jax_tree

torch.set_num_threads(1)
PCP_FRAMES = 20


def test_render_blob_crop_equals_jax():
    rng = np.random.default_rng(1)
    kps = np.stack([rng.uniform(-8, 72, 17), rng.uniform(-8, 104, 17)], axis=-1)
    got = te.render_blob_crop(kps, 96, 64)
    np.testing.assert_array_equal(got, je.render_blob_crop(kps, 96, 64))
    assert got.dtype == np.float32 and got.std() > 0.01


def test_image_to_crop_equals_jax():
    rng = np.random.default_rng(0)
    ebox = np.array([100.0, 50.0, 292.0, 338.0], np.float32)
    kps = np.stack([rng.uniform(ebox[0], ebox[2], 17), rng.uniform(ebox[1], ebox[3], 17)], -1)
    np.testing.assert_array_equal(te.image_to_crop(kps, ebox, 96, 64),
                                  je.image_to_crop(kps, ebox, 96, 64))


def test_crop_boxes_for_scene_match_jax():
    cfg = th.tiny_test_config()
    kps, eboxes = te.crop_boxes_for_scene(make_scene(num_frames=4, num_actors=2, noise_px=0.0),
                                          cfg)
    kps_j, eboxes_j = je.crop_boxes_for_scene(
        j_make_scene(num_frames=4, num_actors=2, noise_px=0.0), tiny_test_config())
    np.testing.assert_array_equal(kps, kps_j)
    assert eboxes.dtype == np.float32 and eboxes.shape == (4 * 5 * 2, 4)
    np.testing.assert_allclose(eboxes, np.asarray(eboxes_j), rtol=1e-6)


@pytest.fixture(scope="module")
def crops():
    """The port's and the JAX package's scene crops: 2 frames x 5 views x
    2 actors at the tiny config's 96x64."""
    scene, crops_t, eboxes_t = te.build_scene_crops(th.tiny_test_config(), num_frames=2)
    _, crops_j, eboxes_j = je.build_scene_crops(tiny_test_config(), num_frames=2)
    return scene, crops_t, eboxes_t, crops_j, eboxes_j


def test_build_scene_crops_match_jax(crops):
    scene, crops_t, eboxes_t, crops_j, eboxes_j = crops
    assert crops_t.shape == (20, 96, 64, 3) and eboxes_t.shape == (20, 4)
    np.testing.assert_allclose(eboxes_t, eboxes_j, rtol=1e-6)
    np.testing.assert_allclose(crops_t, crops_j, rtol=0, atol=1e-6)
    assert scene.num_frames == 2 and crops_t.std() > 0.005


def _model():
    model = th.hrnet_init(th.tiny_test_config(), torch.Generator().manual_seed(4))
    return model.eval()


def test_decode_tree_feeds_raw_crops():
    """The port's `decode_tree` equals HRNet on the raw crops (bf16, no
    normalization) and the plain decode, batch for batch."""
    _, crops_t, eboxes = te.build_scene_crops(th.tiny_test_config(), num_frames=2,
                                             num_actors=1)
    model = _model()
    got = te.decode_tree(model, model.cfg, crops_t, eboxes, "quarter", batch=4, device="cpu")
    want = []
    with torch.no_grad():
        for i in range(0, crops_t.shape[0], 4):
            x = torch.from_numpy(crops_t[i:i + 4]).permute(0, 3, 1, 2).contiguous()
            want.append(decode_heatmaps(model(x), torch.from_numpy(eboxes[i:i + 4]),
                                        refine="quarter"))
    assert got.shape == (10, 17, 3)
    np.testing.assert_array_equal(got, torch.cat(want).numpy())


def test_decode_tree_matches_jax_in_f32(crops):
    """The forward-then-decode that `decode_tree` runs (pinned to it by the
    test above), here in f32 batch by batch, against the JAX forward and
    decode on the same crops."""
    _, crops_t, eboxes, _, _ = crops
    model = _model()
    got = []
    with torch.no_grad():
        for i in range(0, crops_t.shape[0], 8):
            x = torch.from_numpy(crops_t[i:i + 8]).permute(0, 3, 1, 2).contiguous()
            got.append(decode_heatmaps(model(x, torch.float32), torch.from_numpy(eboxes[i:i + 8]),
                                       refine="quarter"))
    got = torch.cat(got).numpy()
    params = _jax_tree(model.state_dict())
    heat = jax.jit(lambda p, x: hrnet_apply(p, tiny_test_config(), x, jnp.float32))(
        params, crops_t)
    want = np.asarray(j_decode(heat, jnp.asarray(eboxes), refine="quarter"))
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-5,
                               atol=1e-5 * float(np.abs(want[..., 2]).max()))


def test_decode_tree_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    crops_t = np.zeros((1, 96, 64, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.decode_tree(_model(), th.tiny_test_config(), crops_t, np.zeros((1, 4), np.float32),
                       "quarter")


def _perfect_kps(scene, score=10.0):
    T, C, A = scene.num_frames, scene.num_cameras, scene.num_actors
    kps = np.concatenate([scene.gt2d, np.full((T, C, A, 17, 1), score)], axis=-1)
    return kps.astype(np.float32).reshape(T * C * A, 17, 3)


def _outliers(scene):
    """tests/test_int8_e2e_pcp.py's residual int8 pattern: 5% of camera 0's
    joints jump 75 px."""
    T, C, A = scene.num_frames, scene.num_cameras, scene.num_actors
    kps = _perfect_kps(scene).reshape(T, C, A, 17, 3).copy()
    rng = np.random.default_rng(7)
    jump = rng.uniform(size=(T, A, 17)) < 0.05
    theta = rng.uniform(0, 2 * np.pi, size=(T, A, 17))
    kps[:, 0, ..., 0] += np.where(jump, 75 * np.cos(theta), 0.0)
    kps[:, 0, ..., 1] += np.where(jump, 75 * np.sin(theta), 0.0)
    assert jump.sum() > 0
    return kps.reshape(T * C * A, 17, 3)


PATTERNS = {"perfect": _perfect_kps, "outliers": _outliers}


@pytest.fixture(scope="module")
def jax_pcp():
    """JAX's `pcp_through_tracker` on both patterns, run once."""
    scene = j_make_scene(num_frames=PCP_FRAMES, num_actors=2, noise_px=0.0)
    return {name: je.pcp_through_tracker(scene, make(scene)) for name, make in PATTERNS.items()}


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_pcp_through_tracker_matches_jax(jax_pcp, pattern):
    scene = make_scene(num_frames=PCP_FRAMES, num_actors=2, noise_px=0.0)
    got = te.pcp_through_tracker(scene, PATTERNS[pattern](scene), device="cpu")
    want = jax_pcp[pattern]
    np.testing.assert_array_equal(got["check_result"], want["check_result"])
    assert got["table"] == want["table"]
    assert got["average"] == want["average"]
    if pattern == "perfect":
        assert got["average"] * 100 >= 99.0, got["table"]
    else:
        assert (jax_pcp["perfect"]["average"] - got["average"]) * 100 < 1.0


def test_joint_colors_are_the_jax_packages():
    np.testing.assert_array_equal(te.render_blob_crop(np.zeros((0, 2)), 4, 4),
                                  np.full((4, 4, 3), 0.35, np.float32))
    from tpupose_torch.models.train import JOINT_COLORS as colors

    np.testing.assert_array_equal(colors, JOINT_COLORS)
