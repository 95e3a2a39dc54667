"""The port's fabricated mini-datasets (`tpupose_torch.data.fabricate`)
against the JAX package's (`tpupose.data.fabricate`), same scene seed and
layout under two roots:

* every image file byte-equal (the same renderer and encoder on the same
  scene), the calibration pickle and the replay dump byte-equal, the GT
  JSONs byte-equal, `actorsGT.mat` equal as loaded (the file's header
  carries its creation time), the YAML equal once the root and the two
  checkpoint paths are set aside;
* the tiny checkpoints differ by design: the port draws them from its own
  models and `torch.Generator`s seeded 0 and 1 (JAX's PRNG is not
  reproduced), so they are held to those models and to the port's
  readers, which load them into models of the YAML's config.
"""
import filecmp
import os

import numpy as np
import pytest
import scipy.io as scio
import torch
import yaml

from tpupose.data import fabricate as jfab
import tpupose_torch.cli.common as tcommon
import tpupose_torch.models.convert as tconv
from tpupose_torch.data import fabricate as tfab
from tpupose_torch.data.config import load_config
from tpupose_torch.models.hrnet import hrnet_init
from tpupose_torch.models.yolov3 import YOLOv3, yolov3_init

torch.set_num_threads(1)
FRAMES = 6


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _same_tree(t_root, j_root, skip=()):
    t_files, j_files = _files(t_root), _files(j_root)
    assert [f for f in t_files if f not in skip] == [f for f in j_files if f not in skip]
    for rel in j_files:
        if rel.endswith((".mat", ".yaml")) or rel in skip:
            continue
        assert filecmp.cmp(os.path.join(t_root, rel), os.path.join(j_root, rel),
                           shallow=False), rel


def _same_yaml(t_paths, j_paths, t_root, j_root):
    with open(t_paths["yaml"]) as f:
        got = yaml.safe_load(f)
    with open(j_paths["yaml"]) as f:
        ref = yaml.safe_load(f)
    for section, key, name in (("DETECT_MODELS", "YOLOV3", "WEIGHT"),
                               ("POSE_MODELS", "HRPOSE", "CHECKPOINT_FILE")):
        got_path = got[section][key][name]
        assert got_path in ("", t_paths.get("yolo_weights"), t_paths.get("hrnet_checkpoint"))
        got[section][key][name] = ref[section][key][name]
    text = yaml.safe_dump(got).replace(str(t_root), str(j_root))
    assert text == yaml.safe_dump(ref)


@pytest.mark.parametrize("options", [{}, {"photo_noise": 6.0, "jpeg_quality": 80},
                                     {"image_format": "png", "seed": 3}])
def test_mini_dataset_equals_jax(tmp_path, options):
    t_root, j_root = tmp_path / "port", tmp_path / "jax"
    t_cfg, t_paths = tfab.fabricate_mini_dataset(t_root, num_frames=FRAMES, **options)
    j_cfg, j_paths = jfab.fabricate_mini_dataset(j_root, num_frames=FRAMES, **options)
    assert os.path.relpath(t_cfg, t_root) == os.path.relpath(j_cfg, j_root)
    assert {k: os.path.relpath(v, t_root) for k, v in t_paths.items() if k != "root"} == \
        {k: os.path.relpath(v, j_root) for k, v in j_paths.items() if k != "root"}
    _same_tree(t_root, j_root)
    _same_yaml(t_paths, j_paths, t_root, j_root)
    got = scio.loadmat(os.path.join(t_root, "actorsGT.mat"))["actor3D"]
    ref = scio.loadmat(os.path.join(j_root, "actorsGT.mat"))["actor3D"]
    assert got.shape == ref.shape == (1, 2)
    for a in range(ref.shape[1]):
        assert got[0, a].shape == ref[0, a].shape == (FRAMES, 1)
        for t in range(FRAMES):
            np.testing.assert_array_equal(got[0, a][t, 0], ref[0, a][t, 0])


def test_mini_panoptic_equals_jax(tmp_path):
    t_root, j_root = tmp_path / "port", tmp_path / "jax"
    _, t_paths = tfab.fabricate_mini_panoptic(t_root, num_frames=FRAMES + 8, gt_start=2)
    _, j_paths = jfab.fabricate_mini_panoptic(j_root, num_frames=FRAMES + 8, gt_start=2)
    assert len(os.listdir(t_root / "hdPose3d_stage1_coco19")) == FRAMES + 6
    _same_tree(t_root, j_root)
    _same_yaml(t_paths, j_paths, t_root, j_root)


def test_tiny_weights_load_into_the_yaml_models(tmp_path):
    _, paths = tfab.fabricate_mini_dataset(tmp_path, num_frames=2, with_weights=True)
    assert paths["yolo_weights"] == os.path.join(tmp_path, "tiny_yolo.weights")
    assert paths["hrnet_checkpoint"] == os.path.join(tmp_path, "tiny_hrnet.pth")
    cfg = load_config(paths["yaml"])
    assert cfg.detect_model.weight == paths["yolo_weights"]
    assert cfg.pose_model.checkpoint_file == paths["hrnet_checkpoint"]
    det_cfg, pose_cfg = tcommon.yolo_config_from(cfg), tcommon.hrnet_config_from(cfg)

    header, _ = tconv.read_darknet_file(paths["yolo_weights"])
    assert header == {"major": 0, "minor": 2, "revision": 0, "seen": 1}
    detector = YOLOv3(det_cfg)
    detector.load_state_dict(tconv.load_darknet_weights(paths["yolo_weights"], det_cfg),
                             strict=True)
    ref = yolov3_init(det_cfg, torch.Generator().manual_seed(0)).state_dict()
    for k, v in detector.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k

    pose = tconv.load_hrnet_torch_checkpoint(paths["hrnet_checkpoint"], pose_cfg)
    ref = hrnet_init(pose_cfg, torch.Generator().manual_seed(1)).state_dict()
    got = pose.state_dict()
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    x = torch.rand((1, 3, *pose_cfg.input_size), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        heat = pose.eval()(x)
    assert heat.shape == (1, 17, pose_cfg.input_size[0] // 4, pose_cfg.input_size[1] // 4)
    assert bool(torch.isfinite(heat).all())
