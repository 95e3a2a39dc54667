"""tpupose_torch: the PyTorch / CUDA port of tpupose for NVIDIA Hopper.

Mirrors the JAX package's layout (geometry, ops, models, tracking,
pipeline, data). Plain tensor code is torch; the heatmap decode (K1,
`csrc/heatmap_decode.cu`) and the int8 serving conv (K2,
`csrc/int8_conv.cu`) are hand-written CUDA kernels, built on first use by
`tpupose_torch.kernels`. Imports no JAX and nothing of `tpupose`.
"""

__version__ = "0.1.0"
