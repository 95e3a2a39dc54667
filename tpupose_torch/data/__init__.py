"""Data helpers: the synthetic multi-camera scene generator."""
from tpupose_torch.data.synthetic import SyntheticScene, camera_ring, make_scene

__all__ = ["SyntheticScene", "camera_ring", "make_scene"]
