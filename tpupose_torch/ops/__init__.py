"""Numerical ops: LAP, smoothing, heatmap decode (kernel K1), image
resampling, NMS, width packing of HRNet branch 0, the CSA matcher's
affinities and match-matrix projections; the int8 conv (kernel K2) is
`ops.int8_conv`."""
from tpupose_torch.ops.affinity import (
    embedding_affinity,
    normalized_geometry_affinity,
    pairwise_affinity,
    pairwise_sq_distances,
)
from tpupose_torch.ops.heatmap import (
    decode_heatmaps,
    decode_heatmaps_auto,
    decode_heatmaps_cuda,
    expand_box_to_aspect,
)
from tpupose_torch.ops.image import crop_and_resize, letterbox_resize, resize_bilinear
from tpupose_torch.ops.lap import PAD_COST, masked_lap, solve_lap
from tpupose_torch.ops.matchmat import proj2dpam, proj2pav, transform_closure
from tpupose_torch.ops.nms import iou_matrix, nms
from tpupose_torch.ops.packing import (
    pack_conv_module_width,
    pack_conv_weight_width,
    pack_hrnet_branch0,
    pack_width,
    unpack_width,
)
from tpupose_torch.ops.smoothing import gaussian_kernel1d, smooth_last, smooth_last_pose

__all__ = [
    "embedding_affinity",
    "normalized_geometry_affinity",
    "pairwise_affinity",
    "pairwise_sq_distances",
    "decode_heatmaps",
    "decode_heatmaps_auto",
    "decode_heatmaps_cuda",
    "expand_box_to_aspect",
    "crop_and_resize",
    "letterbox_resize",
    "resize_bilinear",
    "PAD_COST",
    "masked_lap",
    "solve_lap",
    "proj2dpam",
    "proj2pav",
    "transform_closure",
    "iou_matrix",
    "nms",
    "pack_conv_module_width",
    "pack_conv_weight_width",
    "pack_hrnet_branch0",
    "pack_width",
    "unpack_width",
    "gaussian_kernel1d",
    "smooth_last",
    "smooth_last_pose",
]
