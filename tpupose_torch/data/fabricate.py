"""Fabricated on-disk mini-dataset: drive the whole real-data code path
(glob -> natsort -> decode -> detect/pose or replay -> track -> pkl ->
PCP) without any real dataset or pretrained weights.

Counterpart of `tpupose/data/fabricate.py`, with the same signatures, the
same files and the same YAML. Under a root directory it writes what the
reference's Campus layout provides (`src/dataset.py:19-45`,
`src/evalmodel.py:120-206`):
  * per-camera image folders (rendered from a synthetic scene),
  * `camera_parameter.pickle` ({P, K, RT} stacks),
  * `actorsGT.mat` in the reference's actor3D cell layout,
  * a cached-2D-detections replay dump (reference dump format),
  * a reference-schema YAML config (plus tiny-model extension keys),
  * optional tiny random checkpoints in the published formats (darknet
    `.weights`, `pose_hrnet` `.pth`), so the NN path runs end to end.

The images, calibration, ground truth, dump and YAML equal the JAX
module's for the same scene. The tiny weights come from the port's own
models drawn from `torch.Generator`s seeded 0 and 1, so they differ from
the JAX module's (JAX's PRNG is not reproduced here).
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

#: COCO-17 skeleton edges for rendering.
_EDGES = [
    (5, 7), (7, 9), (6, 8), (8, 10), (11, 13), (13, 15), (12, 14), (14, 16),
    (5, 6), (11, 12), (5, 11), (6, 12), (0, 5), (0, 6),
]

#: The YAML's PERSON_MATCHERS section, on both layouts.
_MATCHERS = {
    "ITERATIVE": {
        "NAME": "Iterative", "EPI_THRESHOLD": 25, "INIT_THRESHOLD": 15,
        "JOINT_THRESHOLD": 15, "NUM_JOINTS": 17, "INIT_METHOD": "GD",
        "N_INIT": 3, "MAX_AGE": 10, "W2D": 0.4, "ALPHA2D": 30,
        "W3D": 0.6, "ALPHA3D": 0.25, "LAMBDA_A": 3, "LAMBDA_T": 5,
        "SIGMA": 0.6, "ARM_SIGMA": 0.8,
    },
}


def render_frame(gt2d_frame, visible, width, height, radius=4):
    """Render one camera view: colored stick figures on a gray background.

    gt2d_frame: (A, J, 2) projections; visible: (A,) bool.
    Returns an (H, W, 3) uint8 RGB array.
    """
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (width, height), (96, 96, 96))
    draw = ImageDraw.Draw(img)
    colors = [(230, 60, 60), (60, 200, 80), (70, 110, 240), (230, 200, 50),
              (200, 70, 220), (70, 220, 220)]
    for a in range(gt2d_frame.shape[0]):
        if not visible[a]:
            continue
        color = colors[a % len(colors)]
        pts = gt2d_frame[a]
        for i, j in _EDGES:
            draw.line(
                [tuple(pts[i].tolist()), tuple(pts[j].tolist())],
                fill=color, width=3,
            )
        for p in pts:
            x, y = float(p[0]), float(p[1])
            draw.ellipse([x - radius, y - radius, x + radius, y + radius],
                         fill=color)
    return np.asarray(img)


def make_actors_gt_mat(path, gt3d):
    """Write `actorsGT.mat` in the reference layout: actor3D is a cell row
    of actors; each actor a cell column over frames; each frame a (14, 3)
    Shelf-order pose (or empty), as `src/evalmodel.py:136-137,150` reads it.
    """
    import scipy.io as scio

    from tpupose_torch.eval.transforms import coco2shelf3d

    T, A = gt3d.shape[:2]
    actor3d = np.empty((1, A), dtype=object)
    for a in range(A):
        frames = np.empty((T, 1), dtype=object)
        for t in range(T):
            frames[t, 0] = coco2shelf3d(gt3d[t, a].T)
        actor3d[0, a] = frames
    scio.savemat(path, {"actor3D": actor3d})


def _default_scene(scene, num_frames, seed):
    from tpupose_torch.data.synthetic import make_scene

    if scene is not None:
        return scene
    return make_scene(num_frames=num_frames, num_cameras=3, num_actors=2,
                      noise_px=0.0, drop_prob=0.0, seed=seed)


def _write_common(root, scene, with_weights):
    """The calibration pickle, the replay dump (8 detection slots a camera)
    and, if asked, the tiny checkpoints. Returns the `paths` dict."""
    from tpupose_torch.data.replay import dets_to_dump_frame, save_detection_dump

    with open(os.path.join(root, "camera_parameter.pickle"), "wb") as f:
        pickle.dump({"P": scene.P, "K": scene.K, "RT": scene.RT}, f)

    dump = {}
    for t in range(scene.num_frames):
        dets = np.zeros((scene.num_cameras, 8, 17, 3), np.float32)
        mask = np.zeros((scene.num_cameras, 8), bool)
        for c, d in enumerate(scene.detections_list(t)):
            n = min(len(d), 8)
            dets[c, :n] = d[:n]
            mask[c, :n] = True
        dump[t] = dets_to_dump_frame(dets, mask)
    dump_path = os.path.join(root, "detections_dump.pkl")
    save_detection_dump(dump_path, dump)

    paths = {"root": root, "dump": dump_path}
    if with_weights:
        paths.update(_fabricate_tiny_weights(root))
    return paths


def _write_yaml(root, dataset_name, cfg, paths):
    import yaml

    cfg_dir = os.path.join(root, "configs", dataset_name)
    os.makedirs(cfg_dir, exist_ok=True)
    cfg_path = os.path.join(cfg_dir, "model_configs.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    paths["yaml"] = cfg_path
    paths["config_dir"] = os.path.join(root, "configs")
    return cfg_path, paths


def _pipeline_section():
    return {
        "DETECT_MODEL": "YOLOv3",
        "POSE_MODEL": "HRPose",
        "PERSON_MATCHER": "Iterative",
        "BUILD_3D": "SVD",
        "CONF_THRESHOLD": 0.4,
    }


def fabricate_mini_dataset(root, scene=None, dataset_name="MiniCampus",
                           num_frames=24, seed=0, with_weights=False,
                           image_format="jpg", photo_noise=0.0,
                           jpeg_quality=None):
    """Build the complete on-disk mini-dataset. Returns (config_path, paths).

    paths: dict with root / dump / yaml / config_dir entries, and
    yolo_weights / hrnet_checkpoint with `with_weights`.
    """
    from PIL import Image

    scene = _default_scene(scene, num_frames, seed)
    root = str(root)
    os.makedirs(root, exist_ok=True)
    folders = [f"Camera{c}" for c in range(scene.num_cameras)]

    # Per-camera frames, natsort-hostile names on purpose (frame10 < frame9
    # lexically) so the natural sort matters. photo_noise > 0 overlays
    # per-pixel uint8 noise before the encode, so the files carry
    # photo-like entropy (a clean stick-figure render compresses to a few
    # KB and decodes unrealistically fast).
    noise_rng = np.random.default_rng(seed + 1)
    kw = {} if jpeg_quality is None else {"quality": jpeg_quality}
    for c, folder in enumerate(folders):
        d = os.path.join(root, folder)
        os.makedirs(d, exist_ok=True)
        for t in range(scene.num_frames):
            img = render_frame(scene.gt2d[t, c], scene.visible[t, c],
                               scene.width, scene.height)
            if photo_noise > 0.0:
                img = np.clip(
                    img.astype(np.int16) + noise_rng.integers(
                        -int(photo_noise), int(photo_noise) + 1, img.shape
                    ),
                    0, 255,
                ).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(d, f"campus4-c{c}-{t}.{image_format}"), **kw
            )

    make_actors_gt_mat(os.path.join(root, "actorsGT.mat"), scene.gt3d)
    paths = _write_common(root, scene, with_weights)
    cfg = {
        "TEST_FUNCTION": "PersonTrack_Project3DPose",
        "PIPELINE_COMBINATION": _pipeline_section(),
        "DATASET": {
            "TEST_DATASET": dataset_name,
            "ROOT": root,
            "FOLDERS_ORDER": folders,
            "CALIBRATION_FILE": "camera_parameter.pickle",
            "DATA_FORMAT": f"*.{image_format}",
            "TEST_RANGE": [0, scene.num_frames],
            "EVAL_RANGE": [5, scene.num_frames],
        },
        **_tiny_model_cfg_sections(paths),
        "PERSON_MATCHERS": _MATCHERS,
        "OUTPUT": os.path.join(root, "results"),
    }
    return _write_yaml(root, dataset_name, cfg, paths)


def _tiny_model_cfg_sections(paths):
    """DETECT_MODELS / POSE_MODELS config sections for the fabricated tiny
    checkpoints (shared by MiniCampus and MiniPanoptic so the NN path is
    configured identically on both)."""
    return {
        "DETECT_MODELS": {
            "YOLOV3": {
                "NAME": "YOLOv3",
                "WEIGHT": paths.get("yolo_weights", ""),
                "SCORE_THRESH": 0.3,
                "NMS_THRESH": 0.4,
                "WIDTH_MULT": 1 / 16,
                "NUM_CLASSES": 2,
                "INPUT_SIZE": 64,
                "MAX_CANDIDATES": 8,
            },
        },
        "POSE_MODELS": {
            "HRPOSE": {
                "NAME": "HRPose",
                "C": 8,
                "NUM_JOINTS": 17,
                "CHECKPOINT_FILE": paths.get("hrnet_checkpoint", ""),
                "MODEL_NAME": "HRNet",
                "RESOLUTION": [96, 64],
                "STEM_CHANNELS": 16,
                "LAYER1_BLOCKS": 1,
                "LAYER1_PLANES": 8,
                "STAGE_MODULES": [1, 1, 1],
                "STAGE_BLOCKS": 1,
            },
        },
    }


def fabricate_mini_panoptic(root, scene=None, num_frames=24, seed=0,
                            gt_start=5, image_format="jpg",
                            with_weights=False):
    """Mini-dataset in the CMU Panoptic layout: timestamped frame names
    (`hd_00_XX_<t:08d>.jpg`, the timestamp parsed from the last `_` suffix,
    `src/dataset.py:37-40`), `hdPose3d_stage1_coco19/body3DScene_*.json` GT
    (every 12th file scored; the axis swap and cm scaling inverted so the
    loader reproduces the 3D GT exactly, `src/evalmodel.py:212-248`), the
    calibration pickle and a replay dump. Returns (config_path, paths)."""
    from PIL import Image

    from tpupose_torch.eval.panoptic import GT_AXES_M
    from tpupose_torch.eval.transforms import coco2panoptic14

    scene = _default_scene(scene, num_frames, seed)
    root = str(root)
    os.makedirs(root, exist_ok=True)
    folders = [f"00_{c:02d}" for c in range(scene.num_cameras)]
    for c, folder in enumerate(folders):
        d = os.path.join(root, folder)
        os.makedirs(d, exist_ok=True)
        for t in range(scene.num_frames):
            img = render_frame(scene.gt2d[t, c], scene.visible[t, c],
                               scene.width, scene.height)
            Image.fromarray(img).save(
                os.path.join(d, f"hd_00_{c:02d}_{t:08d}.{image_format}")
            )

    # GT jsons: the file list starts at gt_start so that the every-12th-file
    # rule lands on post-warmup timestamps (gt_start, gt_start + 12, ...).
    anno = os.path.join(root, "hdPose3d_stage1_coco19")
    os.makedirs(anno, exist_ok=True)
    Minv = GT_AXES_M.T  # orthogonal
    for t in range(gt_start, scene.num_frames):
        bodies = []
        for a in range(scene.num_actors):
            p14_mm = coco2panoptic14(scene.gt3d[t, a].T) * 1000.0
            raw = (p14_mm / 10.0) @ Minv  # loader: raw @ M * 10 -> mm
            j19 = np.zeros((19, 4))
            j19[1:15, :3] = raw
            j19[:, 3] = 1.0
            j19[0, :3] = raw[0]
            j19[15:, :3] = raw[0]
            bodies.append({"id": a, "joints19": j19.ravel().tolist()})
        with open(os.path.join(anno, f"body3DScene_{t:08d}.json"), "w") as f:
            json.dump({"version": 0.7, "univTime": float(t), "bodies": bodies}, f)

    paths = _write_common(root, scene, with_weights)
    cfg = {
        "TEST_FUNCTION": "PersonTrack_Project3DPose",
        "PIPELINE_COMBINATION": _pipeline_section(),
        "DATASET": {
            "TEST_DATASET": "Panoptic",
            "ROOT": root,
            "FOLDERS_ORDER": folders,
            "CALIBRATION_FILE": "camera_parameter.pickle",
            "DATA_FORMAT": f"*.{image_format}",
            "TEST_RANGE": [0, scene.num_frames],
            "EVAL_RANGE": [[0, scene.num_frames]],
        },
        **_tiny_model_cfg_sections(paths),
        "PERSON_MATCHERS": _MATCHERS,
        "OUTPUT": os.path.join(root, "results"),
    }
    return _write_yaml(root, "Panoptic", cfg, paths)


def _fabricate_tiny_weights(root):
    """Random tiny checkpoints in the published formats: a darknet 0.2
    `.weights` file (YOLOv3 from a generator seeded 0) and a `pose_hrnet`
    `.pth` state_dict (HRNet from a generator seeded 1)."""
    import torch

    from tpupose_torch.models.convert import state_dict_to_darknet_array, write_darknet_file
    from tpupose_torch.models.hrnet import HRNetConfig, hrnet_init
    from tpupose_torch.models.yolov3 import YoloConfig, yolov3_init

    det_cfg = YoloConfig(num_classes=2, input_size=64, width_mult=1 / 16,
                         max_candidates=8)
    detector = yolov3_init(det_cfg, torch.Generator().manual_seed(0))
    yolo_path = os.path.join(root, "tiny_yolo.weights")
    write_darknet_file(
        yolo_path, {"major": 0, "minor": 2, "revision": 0, "seen": 1},
        state_dict_to_darknet_array(detector.state_dict(), det_cfg),
    )

    pose_cfg = HRNetConfig(
        width=8, input_size=(96, 64), stem_channels=16, layer1_blocks=1,
        layer1_planes=8, stage_modules=(1, 1, 1), stage_blocks=1,
    )
    pose = hrnet_init(pose_cfg, torch.Generator().manual_seed(1))
    hrnet_path = os.path.join(root, "tiny_hrnet.pth")
    torch.save(pose.state_dict(), hrnet_path)
    return {"yolo_weights": yolo_path, "hrnet_checkpoint": hrnet_path}
