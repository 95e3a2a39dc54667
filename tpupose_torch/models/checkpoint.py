"""Save and restore parameters and training state, so long runs resume.

Counterpart of `tpupose/models/checkpoint.py`, with `torch.save` /
`torch.load(weights_only=True)` in place of orbax. What is saved is a
module's `state_dict` (float, BN-folded, or quantized with its int8
`weight_q` and f32 scales) or an optimizer's; a module's restores into a
module of the same structure, an optimizer's into an optimizer over the
same tensors.
"""
from __future__ import annotations

import os

import torch


def save_params(path: str, obj) -> None:
    """Write `obj`, a module's or an optimizer's state_dict, to `path`,
    creating its directory."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path)


def _check_dtypes(got: dict, want: dict) -> None:
    """Raise ValueError where a saved tensor has another dtype than the
    module's (strict `load_state_dict` checks keys and shapes, and would
    cast)."""
    for k, ref in want.items():
        t = got.get(k)
        if t is not None and t.dtype != ref.dtype:
            raise ValueError(f"restore_params: {k} is {t.dtype}, expected {ref.dtype}")


def _check_state_shapes(sd, opt: torch.optim.Optimizer) -> None:
    """Raise ValueError where a saved per-parameter state tensor (the step
    counters aside) has another shape than its parameter, which
    `Optimizer.load_state_dict` does not check."""
    saved = [i for g in sd["param_groups"] for i in g["params"]]
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in zip(saved, params):
        for k, t in sd["state"].get(i, {}).items():
            if k != "step" and torch.is_tensor(t) and t.shape != p.shape:
                raise ValueError(f"optimizer state: {k} of parameter {i} is "
                                 f"{tuple(t.shape)}, the parameter {tuple(p.shape)}")


def restore_params(path: str, like=None):
    """Read what `save_params` wrote.

    With `like`, a module or an optimizer, restoring loads into it (on its
    devices) and returns it. It raises on a missing or unexpected key, on
    a tensor of another shape (RuntimeError from a strict
    `load_state_dict`; ValueError from `Optimizer.load_state_dict` for
    parameter groups of other sizes) and on another dtype or a state tensor
    of another shape (ValueError). An optimizer keeps its own `capturable`
    setting, which follows its tensors' device (a CPU run's state resumes
    in a card's CUDA graph, and a card's on the CPU). Without it, returns
    the saved state_dict with its tensors on the CPU."""
    obj = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if like is None:
        return obj
    if isinstance(like, torch.optim.Optimizer):
        _check_state_shapes(obj, like)
        for saved, group in zip(obj["param_groups"], like.param_groups):
            if "capturable" in group:
                saved["capturable"] = group["capturable"]
        like.load_state_dict(obj)
    else:
        _check_dtypes(obj, like.state_dict())
        like.load_state_dict(obj, strict=True)
    return like
