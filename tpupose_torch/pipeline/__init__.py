"""Pipeline facade."""
from tpupose_torch.pipeline.facade import Pipeline, resolve_device

__all__ = ["Pipeline", "resolve_device"]
