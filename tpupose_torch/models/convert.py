"""Weights across from the JAX package's parameter trees.

The JAX trees are nested dicts whose key paths are torch state_dict names
with HWIO conv kernels; `np.asarray` of every leaf gives the input here.
The result loads with `load_state_dict(strict=True)` into the matching
module: `HRNet` / `YOLOv3` for a plain tree, the same module after
`fold_batchnorm` for a folded tree (whose BN dicts are empty), and for a
quantized tree the module that `quantize.quantize_convs` returns for the
same skip set (int8 `weight_q` HWIO -> OIHW; `w_scale`, `x_scale` and
`bias` as they are).
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from _flatten(value, name)
        else:
            yield name, np.asarray(value)


def state_dict_from_jax(tree) -> dict:
    """Nested numpy tree -> flat torch state_dict: 4-D conv kernels (float
    `weight` and int8 `weight_q`) HWIO -> OIHW, and a zero
    `num_batches_tracked` beside every BN."""
    sd = {}
    for name, arr in _flatten(tree):
        if arr.ndim == 4 and name.endswith(("weight", "weight_q")):
            arr = arr.transpose(3, 2, 0, 1)
        sd[name] = torch.tensor(arr)
        if name.endswith("running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def hrnet_state_dict_from_jax(tree) -> dict:
    """The JAX HRNet tree (numpy leaves) as the port's HRNet state_dict."""
    return state_dict_from_jax(tree)


def yolo_state_dict_from_jax(tree) -> dict:
    """The JAX YOLOv3 tree (numpy leaves) as the port's YOLOv3 state_dict."""
    return state_dict_from_jax(tree)
