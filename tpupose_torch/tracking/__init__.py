"""Multi-view 3D pose tracking."""
from tpupose_torch.tracking.tracker import (
    FrameOutput,
    TrackerConfig,
    TrackerState,
    init_state,
    make_step_fn,
    stack_outputs,
    track_clip,
    tracker_step,
)

__all__ = [
    "FrameOutput",
    "TrackerConfig",
    "TrackerState",
    "init_state",
    "make_step_fn",
    "stack_outputs",
    "track_clip",
    "tracker_step",
]
