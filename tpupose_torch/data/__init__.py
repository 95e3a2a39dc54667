"""Configs, dataset manifests, the synthetic multi-camera scene."""
from tpupose_torch.data.config import (
    Config,
    config_from_raw,
    load_config,
    tracker_config_from,
)
from tpupose_torch.data.dataset import load_filenames, load_images, parse_timestamp
from tpupose_torch.data.synthetic import SyntheticScene, camera_ring, make_scene

__all__ = [
    "Config",
    "config_from_raw",
    "load_config",
    "tracker_config_from",
    "load_filenames",
    "load_images",
    "parse_timestamp",
    "SyntheticScene",
    "camera_ring",
    "make_scene",
]
