"""Neural backends: HRNet and YOLOv3 as nn.Modules, weight conversion and
checkpoint loading, int8 post-training quantization; training (`train`)
and save / resume (`checkpoint`) in their own modules."""
from tpupose_torch.models.convert import (
    darknet_array_to_state_dict,
    hrnet_state_dict_from_jax,
    load_darknet_weights,
    load_hrnet_torch_checkpoint,
    read_darknet_file,
    state_dict_from_jax,
    state_dict_to_darknet_array,
    write_darknet_file,
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
    "darknet_array_to_state_dict",
    "hrnet_state_dict_from_jax",
    "load_darknet_weights",
    "load_hrnet_torch_checkpoint",
    "read_darknet_file",
    "state_dict_from_jax",
    "state_dict_to_darknet_array",
    "write_darknet_file",
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
