"""tpupose_torch: the PyTorch / CUDA port of tpupose for NVIDIA Hopper.

Mirrors the JAX package's layout (geometry, ops, models, tracking,
pipeline, data). Plain tensor code is torch; the heatmap decode is a
hand-written CUDA kernel (`csrc/heatmap_decode.cu`, built on first use by
`tpupose_torch.kernels`). Imports no JAX and nothing of `tpupose`.
"""

__version__ = "0.1.0"
