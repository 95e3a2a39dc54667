"""Weights in: the JAX package's parameter trees and the published
checkpoint formats.

JAX trees are nested dicts whose key paths are torch state_dict names with
HWIO conv kernels; `np.asarray` of every leaf gives the input of
`state_dict_from_jax`. The result loads with `load_state_dict(strict=True)`
into the matching module: `HRNet` / `YOLOv3` for a plain tree, the same
module after `fold_batchnorm` for a folded tree (whose BN dicts are empty),
for a quantized tree the module that `quantize.quantize_convs` returns
for the same skip set (int8 `weight_q` HWIO -> OIHW; `w_scale`, `x_scale`
and `bias` as they are), and for a fake-quant (QAT) tree the module that
`quantize.fake_quant_convs` returns (its 0-d `fq_x_scale` as it is).
`adam_state_from_jax` carries an optax Adam / AdamW state over the same
way, into a torch optimizer's `state_dict`.

The published checkpoints (`src/configs/*/model_configs.yaml:38-57`) load
with no JAX: a darknet `.weights` file (`read_darknet_file`,
`load_darknet_weights`) and a `pose_hrnet` `.pth` state_dict
(`load_hrnet_torch_checkpoint`), whose keys are the port's HRNet names;
and an mmpose ViTPose checkpoint (`load_vitpose_checkpoint`), whose
`backbone.*` / `keypoint_head.*` keys are the port's ViTPose names.
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


def _adam_state(opt_state):
    """The `ScaleByAdamState` (fields count, mu, nu) inside an optax state,
    a nest of tuples."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state, model, optimizer) -> dict:
    """The state of `optax.adam` / `optax.adamw` as a `state_dict` for the
    torch Adam / AdamW `optimizer` over tensors of `model`.

    `mu` and `nu` are trees in the parameter tree's layout (numpy or JAX
    leaves; conv kernels HWIO, turned OIHW); each optimizer tensor takes
    the leaf of its name in `model` (a parameter, or a buffer such as a BN
    running statistic), and `count` becomes every tensor's `step`. Load
    the result with `optimizer.load_state_dict`; a JAX run then resumes
    in the port. Raises ValueError for an optimizer tensor not in `model`
    or not in the trees."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("adam_state_from_jax: no Adam state (count, mu, nu) in opt_state")
    mu, nu = state_dict_from_jax(adam.mu), state_dict_from_jax(adam.nu)
    names = {id(t): n for n, t in model.named_parameters()}
    names.update((id(t), n) for n, t in model.named_buffers())
    step = float(np.asarray(adam.count))
    sd = optimizer.state_dict()
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names.get(id(p))
            if name is None or name not in mu:
                raise ValueError(f"adam_state_from_jax: optimizer tensor {index} "
                                 f"({name or 'not in the model'}) has no JAX state")
            state[index] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": mu[name].to(dtype=p.dtype, device=p.device),
                "exp_avg_sq": nu[name].to(dtype=p.dtype, device=p.device),
            }
            index += 1
    return {"state": state, "param_groups": sd["param_groups"]}


# -- pose_hrnet .pth -------------------------------------------------------------

def load_hrnet_torch_checkpoint(path, cfg):
    """A `pose_hrnet` `.pth` checkpoint as the port's `HRNet` for `cfg`.

    Unwraps a `{"state_dict": ...}` container and strips a `module.`
    prefix (a DataParallel save), then loads with `strict=True`: the
    official keys are the port's module names. Returns the HRNet on the
    CPU, BN not folded."""
    from tpupose_torch.models.hrnet import HRNet

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    model = HRNet(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def load_vitpose_checkpoint(path, cfg):
    """An mmpose ViTPose checkpoint (`{"state_dict": ...}`, the official
    release's container) as the port's `ViTPose` for `cfg`, loaded with
    `strict=True`: the official `backbone.*` and `keypoint_head.*` keys are
    the port's module names. A bare state_dict loads too. Returns the model
    on the CPU, BN not folded."""
    from tpupose_torch.models.vitpose import ViTPose

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = ViTPose(cfg)
    model.load_state_dict(sd, strict=True)
    return model


# -- darknet .weights --------------------------------------------------------------

def _seen_dtype(major, minor):
    # `seen` is int64 from format version 0.2 on (yolov3.weights ships as
    # 0.2) and int32 before; reading the wrong width misaligns every weight
    # by 4 bytes.
    return np.int64 if major * 10 + minor >= 2 else np.int32


def read_darknet_file(path):
    """Read a darknet `.weights` binary: the header is 3x int32 (major,
    minor, revision) then the image counter `seen` (int32 or int64 by
    version), then float32 weights to the end of the file.

    Returns:
      (header dict with major/minor/revision/seen, float32 weight array)
    """
    with open(path, "rb") as f:
        version = np.fromfile(f, dtype=np.int32, count=3)
        if version.size != 3:
            raise ValueError(f"not a darknet weights file: {path}")
        major, minor, revision = (int(v) for v in version)
        seen = np.fromfile(f, dtype=_seen_dtype(major, minor), count=1)
        data = np.fromfile(f, dtype=np.float32)
    header = {
        "major": major,
        "minor": minor,
        "revision": revision,
        "seen": int(seen[0]) if seen.size else 0,
    }
    return header, data


def write_darknet_file(path, header, data):
    """Inverse of `read_darknet_file`."""
    major, minor = header["major"], header["minor"]
    with open(path, "wb") as f:
        np.asarray([major, minor, header.get("revision", 0)], np.int32).tofile(f)
        np.asarray([header.get("seen", 0)], _seen_dtype(major, minor)).tofile(f)
        np.asarray(data, np.float32).tofile(f)


def darknet_array_to_state_dict(data, cfg) -> dict:
    """A darknet float payload -> the port's `YOLOv3` state_dict for `cfg`.

    Per conv, in `YoloConfig.conv_specs` order: with BN, bn bias, bn scale,
    bn mean, bn var, then the OIHW weights; without BN (the three detection
    heads), the conv bias, then the OIHW weights. Raises ValueError when the
    payload is shorter or longer than the network."""
    from tpupose_torch.models.yolov3 import conv_in_channels

    data = np.asarray(data, np.float32)
    sd = {}
    ptr = 0

    def take(n, shape=None):
        nonlocal ptr
        if ptr + n > data.size:
            raise ValueError(f"darknet weights exhausted at {ptr} of {data.size} "
                             f"floats, need {n} more")
        out = torch.from_numpy(data[ptr:ptr + n].reshape(shape or (n,)))
        ptr += n
        return out

    for i, ((cout, k, _, bn), cin) in enumerate(zip(cfg.conv_specs,
                                                    conv_in_channels(cfg))):
        p = f"conv{i}."
        if bn:
            sd[p + "bn.bias"] = take(cout)
            sd[p + "bn.weight"] = take(cout)
            sd[p + "bn.running_mean"] = take(cout)
            sd[p + "bn.running_var"] = take(cout)
            sd[p + "bn.num_batches_tracked"] = torch.tensor(0)
        else:
            sd[p + "conv.bias"] = take(cout)
        sd[p + "conv.weight"] = take(cout * cin * k * k, (cout, cin, k, k))
    if ptr != data.size:
        raise ValueError(f"darknet weights: {data.size - ptr} trailing floats "
                         f"after the {ptr} the network holds")
    return sd


def state_dict_to_darknet_array(sd, cfg) -> np.ndarray:
    """Inverse of `darknet_array_to_state_dict`: a `YOLOv3` state_dict (BN
    not folded) in darknet file order, float32."""
    chunks = []
    for i, (_, _, _, bn) in enumerate(cfg.conv_specs):
        p = f"conv{i}."
        names = (["bn.bias", "bn.weight", "bn.running_mean", "bn.running_var"]
                 if bn else ["conv.bias"]) + ["conv.weight"]
        chunks += [sd[p + n].detach().float().cpu().numpy().ravel() for n in names]
    return np.concatenate(chunks).astype(np.float32)


def load_darknet_weights(path, cfg) -> dict:
    """A darknet `.weights` file as the port's `YOLOv3` state_dict for
    `cfg` (BN not folded)."""
    _, data = read_darknet_file(path)
    return darknet_array_to_state_dict(data, cfg)
