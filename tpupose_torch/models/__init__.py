"""Neural backends: HRNet and YOLOv3 as nn.Modules, weight conversion,
int8 post-training quantization."""
from tpupose_torch.models.convert import (
    hrnet_state_dict_from_jax,
    state_dict_from_jax,
    yolo_state_dict_from_jax,
)
from tpupose_torch.models.hrnet import (
    HRNet,
    HRNetConfig,
    hrnet_init,
    hrnet_w32_config,
    hrnet_w48_config,
    normalize_image,
)
from tpupose_torch.models.layers import QuantConv2d, fold_batchnorm
from tpupose_torch.models.quantize import (
    QuantizationDriftError,
    calibrate,
    quantize_convs,
    quantize_hrnet,
    quantize_yolo,
)
from tpupose_torch.models.yolov3 import (
    YOLOv3,
    YoloConfig,
    decode_detections,
    detect_people,
    yolov3_init,
)

__all__ = [
    "hrnet_state_dict_from_jax",
    "state_dict_from_jax",
    "yolo_state_dict_from_jax",
    "HRNet",
    "HRNetConfig",
    "hrnet_init",
    "hrnet_w32_config",
    "hrnet_w48_config",
    "normalize_image",
    "fold_batchnorm",
    "QuantConv2d",
    "QuantizationDriftError",
    "calibrate",
    "quantize_convs",
    "quantize_hrnet",
    "quantize_yolo",
    "YOLOv3",
    "YoloConfig",
    "decode_detections",
    "detect_people",
    "yolov3_init",
]
