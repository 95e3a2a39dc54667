"""Typed configuration with reference-YAML compatibility.

Counterpart of `tpupose/data/config.py`. Accepts the reference's exact
YAML schema (`src/configs/*/model_configs.yaml`, loaded untyped via
EasyDict at `src/dataset.py:13-17`) and validates it into dataclasses,
repairing the shipped Panoptic config's `PERSON_M` typo for
`PERSON_MATCHERS` (SURVEY.md §2.3) instead of crashing.

`load_config(path)` is `yaml.safe_load` of the file followed by
`config_from_raw`, so code that holds the reference-schema dict already
builds a `Config` without PyYAML.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DatasetConfig:
    test_dataset: str
    root: str
    folders_order: list
    calibration_file: str = "camera_parameter.pickle"
    data_format: str = "*.jpg"
    test_range: tuple = (0, 0)
    eval_range: list = dataclasses.field(default_factory=list)
    gt_file: str = ""
    data_type: str = "Images"


@dataclasses.dataclass
class DetectModelConfig:
    name: str = "YOLOv3"
    cfg: str = ""
    weight: str = ""
    class_names: str = ""
    score_thresh: float = 0.5
    nms_thresh: float = 0.4
    # Extensions absent from the reference YAMLs (-> the real yolov3):
    # channel multiplier / class count / input size of reduced variants,
    # for the tests' tiny checkpoints.
    width_mult: float = 1.0
    num_classes: int = 80
    input_size: int = 416
    max_candidates: int = 64


@dataclasses.dataclass
class PoseModelConfig:
    name: str = "HRPose"
    c: int = 48
    num_joints: int = 17
    checkpoint_file: str = ""
    model_name: str = "HRNet"
    resolution: tuple = (384, 288)
    # Extensions absent from the reference YAMLs (-> the real pose_hrnet
    # topology): the tests' reduced variants.
    stem_channels: int = 64
    layer1_blocks: int = 4
    layer1_planes: int = 64
    stage_modules: tuple = (1, 4, 3)
    stage_blocks: int = 4
    #: sub-pixel decode: "quarter" (official HRNet shift) or "parabolic"
    decode_refine: str = "quarter"
    # ViTPose's backbone widths (POSE_MODEL "ViTPose"; the port's own keys,
    # absent from the JAX package): ViT-H by default, the tests' reduced
    # variants otherwise. ViTPose's crop size is RESOLUTION (256x192
    # published).
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16


@dataclasses.dataclass
class MatcherConfig:
    """Tracker hyper-parameters; the JAX package's `MatcherConfig`
    documents the keys the reference lacks (JOINT_GATE, RESURRECT_*,
    TIE_EPS)."""

    name: str = "Iterative"
    epi_threshold: float = 25.0
    init_threshold: float = 15.0
    joint_threshold: float = 15.0
    num_joints: int = 17
    init_method: str = "GD"
    n_init: int = 3
    max_age: int = 10
    w2d: float = 0.4
    alpha2d: float = 30.0
    w3d: float = 0.6
    alpha3d: float = 0.25
    lambda_a: float = 3.0
    lambda_t: float = 5.0
    sigma: float = 0.6
    arm_sigma: float = 0.8
    joint_gate: int = 10
    resurrect_window: int = 0
    resurrect_dist: float = 0.5
    resurrect_speed: float = 0.06
    tie_eps: float = 3e-3


@dataclasses.dataclass
class PipelineConfig:
    detect_model: str = "YOLOv3"
    pose_model: str = "HRPose"
    person_matcher: str = "Iterative"
    build_3d: str = "SVD"
    conf_threshold: float = 0.4


@dataclasses.dataclass
class Config:
    test_function: str
    pipeline: PipelineConfig
    dataset: DatasetConfig
    detect_model: DetectModelConfig
    pose_model: PoseModelConfig
    matcher: MatcherConfig
    output: str = "results"
    visualization: bool = False
    save_image: bool = False
    raw: Optional[dict] = None


def _eval_ranges(value):
    """The YAML stores EVAL_RANGE as either [a, b] or [[a, b], [c, d]]."""
    if not value:
        return []
    if isinstance(value[0], (list, tuple)):
        return [tuple(v) for v in value]
    return [tuple(value)]


def load_config(path: str) -> Config:
    """Parse a reference-schema YAML file into a `Config`."""
    import yaml

    with open(path) as f:
        text = f.read()
    try:
        raw = yaml.safe_load(text)
    except yaml.YAMLError:
        # The reference's shipped Panoptic YAML is not valid YAML: the
        # PERSON_MATCHERS key is truncated to a bare `PERSON_M` line with no
        # colon (`src/configs/Panoptic/model_configs.yaml:59`). Repair and
        # retry.
        repaired = []
        for line in text.splitlines():
            if line.strip() == "PERSON_M":
                line = line.replace("PERSON_M", "PERSON_MATCHERS:")
            repaired.append(line)
        raw = yaml.safe_load("\n".join(repaired))
    return config_from_raw(raw)


def config_from_raw(raw: dict) -> Config:
    """Build a `Config` from the reference-schema dict (what
    `yaml.safe_load` gives for a config file)."""
    pipe = raw["PIPELINE_COMBINATION"]
    pipeline = PipelineConfig(
        detect_model=pipe.get("DETECT_MODEL", "YOLOv3"),
        pose_model=pipe.get("POSE_MODEL", "HRPose"),
        person_matcher=pipe.get("PERSON_MATCHER", "Iterative"),
        build_3d=pipe.get("BUILD_3D", "SVD"),
        conf_threshold=float(pipe.get("CONF_THRESHOLD", 0.4)),
    )

    ds = raw["DATASET"]
    dataset = DatasetConfig(
        test_dataset=ds["TEST_DATASET"],
        root=ds["ROOT"],
        folders_order=list(ds["FOLDERS_ORDER"]),
        calibration_file=ds.get("CALIBRATION_FILE", "camera_parameter.pickle"),
        data_format=ds.get("DATA_FORMAT", "*.jpg"),
        test_range=tuple(ds.get("TEST_RANGE", (0, 0))),
        eval_range=_eval_ranges(ds.get("EVAL_RANGE", [])),
        gt_file=ds.get("GT_FILE", ""),
        data_type=ds.get("DATA_TYPE", "Images"),
    )

    det_models = raw.get("DETECT_MODELS", {})
    dm = det_models.get(pipeline.detect_model.upper(), {}) or {"NAME": ""}
    detect = DetectModelConfig(
        name=dm.get("NAME", ""),
        cfg=dm.get("CFG", ""),
        weight=dm.get("WEIGHT", ""),
        class_names=dm.get("CLASS_NAMES", ""),
        score_thresh=float(dm.get("SCORE_THRESH", 0.5)),
        nms_thresh=float(dm.get("NMS_THRESH", 0.4)),
        width_mult=float(dm.get("WIDTH_MULT", 1.0)),
        num_classes=int(dm.get("NUM_CLASSES", 80)),
        input_size=int(dm.get("INPUT_SIZE", 416)),
        max_candidates=int(dm.get("MAX_CANDIDATES", 64)),
    )

    pose_models = raw.get("POSE_MODELS", {})
    pm = pose_models.get(pipeline.pose_model.upper(), {})
    pose = PoseModelConfig(
        name=pm.get("NAME", "HRPose"),
        c=int(pm.get("C", 48)),
        num_joints=int(pm.get("NUM_JOINTS", 17)),
        checkpoint_file=pm.get("CHECKPOINT_FILE", ""),
        model_name=pm.get("MODEL_NAME", "HRNet"),
        resolution=tuple(pm.get("RESOLUTION", (384, 288))),
        stem_channels=int(pm.get("STEM_CHANNELS", 64)),
        layer1_blocks=int(pm.get("LAYER1_BLOCKS", 4)),
        layer1_planes=int(pm.get("LAYER1_PLANES", 64)),
        stage_modules=tuple(pm.get("STAGE_MODULES", (1, 4, 3))),
        stage_blocks=int(pm.get("STAGE_BLOCKS", 4)),
        decode_refine=str(pm.get("DECODE_REFINE", "quarter")),
        embed_dim=int(pm.get("EMBED_DIM", 1280)),
        depth=int(pm.get("DEPTH", 32)),
        num_heads=int(pm.get("NUM_HEADS", 16)),
    )

    # Tolerate the shipped Panoptic YAML's PERSON_M typo (SURVEY.md §2.3).
    matchers = raw.get("PERSON_MATCHERS") or raw.get("PERSON_M") or {}
    mm = matchers.get(pipeline.person_matcher.upper(), {})
    matcher = MatcherConfig(
        name=mm.get("NAME", "Iterative"),
        epi_threshold=float(mm.get("EPI_THRESHOLD", 25)),
        init_threshold=float(mm.get("INIT_THRESHOLD", 15)),
        joint_threshold=float(mm.get("JOINT_THRESHOLD", 15)),
        num_joints=int(mm.get("NUM_JOINTS", 17)),
        init_method=mm.get("INIT_METHOD", "GD"),
        n_init=int(mm.get("N_INIT", 3)),
        max_age=int(mm.get("MAX_AGE", 10)),
        w2d=float(mm.get("W2D", 0.4)),
        alpha2d=float(mm.get("ALPHA2D", 30)),
        w3d=float(mm.get("W3D", 0.6)),
        alpha3d=float(mm.get("ALPHA3D", 0.25)),
        lambda_a=float(mm.get("LAMBDA_A", 3)),
        lambda_t=float(mm.get("LAMBDA_T", 5)),
        sigma=float(mm.get("SIGMA", 0.6)),
        arm_sigma=float(mm.get("ARM_SIGMA", 0.8)),
        joint_gate=int(mm.get("JOINT_GATE", 10)),
        resurrect_window=int(mm.get("RESURRECT_WINDOW", 0)),
        resurrect_dist=float(mm.get("RESURRECT_DIST", 0.5)),
        resurrect_speed=float(mm.get("RESURRECT_SPEED", 0.06)),
        tie_eps=float(mm.get("TIE_EPS", 3e-3)),
    )

    return Config(
        test_function=raw.get("TEST_FUNCTION", "PersonTrack_Project3DPose"),
        pipeline=pipeline,
        dataset=dataset,
        detect_model=detect,
        pose_model=pose,
        matcher=matcher,
        output=raw.get("OUTPUT", "results"),
        visualization=bool(raw.get("VISUALIZATION", False)),
        save_image=bool(raw.get("SAVE_IMAGE", False)),
        raw=raw,
    )


def tracker_config_from(cfg: Config, num_cameras: int, **overrides):
    """The port's `TrackerConfig` from a loaded Config."""
    from tpupose_torch.tracking.tracker import TrackerConfig

    m = cfg.matcher
    kw = dict(
        num_cameras=num_cameras,
        num_joints=m.num_joints,
        conf_threshold=cfg.pipeline.conf_threshold,
        epi_threshold=m.epi_threshold,
        init_threshold=m.init_threshold,
        joint_threshold=m.joint_threshold,
        n_init=m.n_init,
        max_age=m.max_age,
        alpha2d=m.alpha2d,
        lambda_a=m.lambda_a,
        lambda_t=m.lambda_t,
        sigma=m.sigma,
        arm_sigma=m.arm_sigma,
        joint_gate=m.joint_gate,
        resurrect_window=m.resurrect_window,
        resurrect_dist=m.resurrect_dist,
        resurrect_speed=m.resurrect_speed,
        tie_eps=m.tie_eps,
    )
    kw.update(overrides)
    return TrackerConfig(**kw)
