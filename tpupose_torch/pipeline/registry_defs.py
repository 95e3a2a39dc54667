"""Default registry entries (detectors, pose models, matchers, init
methods, 3D builders, test functions).

Counterpart of `tpupose/pipeline/registry_defs.py`, with factories that
build the port's modules. Importing this module fills the registries of
`tpupose_torch.utils.registry`.
"""
from __future__ import annotations

from tpupose_torch.utils.registry import (
    BUILD_3D_KERNELS,
    DETECTORS,
    INIT_METHODS,
    MATCHERS,
    POSE_MODELS,
    TEST_FUNCTIONS,
)


@DETECTORS.register("yolov3")
def build_yolov3(cfg):
    """cfg: data.config.DetectModelConfig -> (YoloConfig, YOLOv3 module on
    the CPU with the darknet `.weights` file loaded, BN not folded)."""
    from tpupose_torch.models.convert import load_darknet_weights
    from tpupose_torch.models.yolov3 import YOLOv3, YoloConfig

    det_cfg = YoloConfig(score_thresh=cfg.score_thresh, nms_thresh=cfg.nms_thresh)
    model = YOLOv3(det_cfg)
    model.load_state_dict(load_darknet_weights(cfg.weight, det_cfg), strict=True)
    return det_cfg, model


@DETECTORS.register("none")
def build_no_detector(cfg):
    return None, None


@POSE_MODELS.register("hrpose")
def build_hrpose(cfg, load=True):
    """cfg: data.config.PoseModelConfig -> (HRNetConfig, HRNet module on
    the CPU with the `pose_hrnet` `.pth` loaded, BN not folded; None
    without `load`)."""
    from tpupose_torch.models.convert import load_hrnet_torch_checkpoint
    from tpupose_torch.models.hrnet import HRNetConfig

    pose_cfg = HRNetConfig(
        width=cfg.c,
        num_joints=cfg.num_joints,
        input_size=tuple(cfg.resolution),
        stem_channels=cfg.stem_channels,
        layer1_blocks=cfg.layer1_blocks,
        layer1_planes=cfg.layer1_planes,
        stage_modules=tuple(cfg.stage_modules),
        stage_blocks=cfg.stage_blocks,
        decode_refine=cfg.decode_refine,
    )
    return pose_cfg, load_hrnet_torch_checkpoint(cfg.checkpoint_file, pose_cfg) if load else None


@POSE_MODELS.register("vitpose")
def build_vitpose(cfg, load=True):
    """cfg: data.config.PoseModelConfig -> (ViTPoseConfig, ViTPose module
    on the CPU with the mmpose checkpoint loaded, BN not folded; None
    without `load`). The port's own entry: the JAX package has no
    ViTPose."""
    from tpupose_torch.models.convert import load_vitpose_checkpoint
    from tpupose_torch.models.vitpose import ViTPoseConfig

    pose_cfg = ViTPoseConfig(
        embed_dim=cfg.embed_dim,
        depth=cfg.depth,
        num_heads=cfg.num_heads,
        input_size=tuple(cfg.resolution),
        num_joints=cfg.num_joints,
        decode_refine=cfg.decode_refine,
    )
    return pose_cfg, load_vitpose_checkpoint(cfg.checkpoint_file, pose_cfg) if load else None


@MATCHERS.register("iterative")
def build_iterative(cfg, num_cameras):
    """cfg: data.config.Config -> TrackerConfig."""
    from tpupose_torch.data.config import tracker_config_from

    return tracker_config_from(cfg, num_cameras=num_cameras)


@INIT_METHODS.register("gd")
def init_method_greedy():
    """Greedy hypothesis building (the INIT_METHOD of every reference
    YAML), done inside the tracker step."""
    return "gd"


@INIT_METHODS.register("bip")
def init_method_bip():
    """BIP clique-partition alternative: its host-side solver is
    `tpupose_torch.tracking.bip` (`solve_clique_partition`,
    `bip_matching`); the tracker step builds hypotheses greedily only."""
    return "bip"


@BUILD_3D_KERNELS.register("svd")
def build_3d_svd():
    """Time-weighted masked DLT-SVD, the production kernel (the
    reference's `SVD_pose_kernel_jf`, `src/utils/construction.py:89-114`)."""
    from tpupose_torch.geometry import triangulate_joints

    return triangulate_joints


@BUILD_3D_KERNELS.register("topdown")
def build_3d_top_down():
    """All-pairs two-view DLT with min-reprojection pair selection (the
    reference's `top_down_pose_kernel`, `src/utils/construction.py:9-31`)."""
    from tpupose_torch.geometry import triangulate_top_down

    return triangulate_top_down


@TEST_FUNCTIONS.register("persontrack_project3dpose")
def test_function_track(cfg, datas):
    raise NotImplementedError(
        "use tpupose_torch.cli.testmodel / evalmodel mains; registered for name "
        "validation of TEST_FUNCTION"
    )
