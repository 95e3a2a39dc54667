"""Evaluation: PCP / Panoptic / MOT scorers, joint transforms, result
writers."""
from tpupose_torch.eval.panoptic import (
    evaluate_panoptic,
    evaluate_panoptic_from_pickle,
    load_panoptic_gt,
)
from tpupose_torch.eval.pcp import evaluate_pcp, evaluate_pcp_from_pickle
from tpupose_torch.eval.transforms import (
    coco2panoptic,
    coco2panoptic14,
    coco2shelf3d,
    coco17to19,
    nan_masked_sqdist,
)
from tpupose_torch.eval.writers import write_2d_result, write_3d_result

__all__ = [
    "evaluate_panoptic",
    "evaluate_panoptic_from_pickle",
    "load_panoptic_gt",
    "evaluate_pcp",
    "evaluate_pcp_from_pickle",
    "coco2panoptic",
    "coco2panoptic14",
    "coco2shelf3d",
    "coco17to19",
    "nan_masked_sqdist",
    "write_2d_result",
    "write_3d_result",
]
