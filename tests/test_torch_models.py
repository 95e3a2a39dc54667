"""tpupose_torch.models against tpupose.models: layers, HRNet and YOLOv3 in
f32 with weights carried across by `models/convert.py`, BN folding, and
the official pose_hrnet key sets.

Tolerances: f32 convolutions from two libraries sum in different orders,
so network outputs agree to 1e-4 of their largest magnitude (the JAX
package's own folding test allows 1e-3); folded weights agree to f32
rounding (rtol 1e-6). Key sets and shapes are exact.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.models.hrnet as jh
import tpupose.models.layers as jl
import tpupose.models.yolov3 as jy
import tpupose_torch.models.hrnet as th
import tpupose_torch.models.layers as tl
import tpupose_torch.models.yolov3 as ty
from tpupose_torch.models.convert import (
    hrnet_state_dict_from_jax,
    yolo_state_dict_from_jax,
)

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jitter_bn(tree, seed):
    rng = np.random.default_rng(seed)

    def jitter(x):
        x = np.asarray(x)
        if x.ndim == 1:
            return np.abs(x + 0.2 * rng.normal(size=x.shape)).astype(np.float32) + 0.1
        return x
    return jax.tree.map(jitter, tree)


def _close(got, ref, frac=1e-4):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=frac * scale)


def test_conv_bn_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)  # NHWC
    xt = torch.as_tensor(x.transpose(0, 3, 1, 2).copy())
    for k, stride in [(3, 1), (3, 2), (1, 1), (1, 2)]:
        w = rng.normal(size=(k, k, 5, 7)).astype(np.float32)
        b = rng.normal(size=7).astype(np.float32)
        ref = np.asarray(jl.conv_apply({"weight": w, "bias": b}, jnp.asarray(x), stride=stride))
        got = tl.conv_apply(torch.as_tensor(w.transpose(3, 2, 0, 1).copy()),
                            torch.as_tensor(b), xt, stride=stride)
        _close(got.permute(0, 2, 3, 1).numpy(), ref, 1e-5)
    bn = {"weight": rng.uniform(0.5, 2, 5), "bias": rng.normal(size=5),
          "running_mean": rng.normal(size=5), "running_var": rng.uniform(0.5, 2, 5)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    mod = tl.BatchNorm2d(5)
    mod.load_state_dict({**{k: torch.as_tensor(v) for k, v in bn.items()},
                         "num_batches_tracked": torch.tensor(0)})
    ref = np.asarray(jl.bn_apply(bn, jnp.asarray(x)))
    with torch.no_grad():
        got = mod(xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tl.max_pool(xt).permute(0, 2, 3, 1).numpy(), np.asarray(jl.max_pool(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tl.upsample_nearest(xt, 2).permute(0, 2, 3, 1).numpy(),
        np.asarray(jl.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_allclose(tl.leaky_relu(xt).numpy(),
                               np.asarray(jl.leaky_relu(jnp.asarray(x))).transpose(0, 3, 1, 2),
                               rtol=1e-7)


@pytest.mark.parametrize("fold", [False, True])
def test_hrnet_f32_matches_jax(fold):
    cfg = th.tiny_test_config()
    params = _jitter_bn(jh.hrnet_init(jax.random.PRNGKey(1), jh.tiny_test_config()), 1)
    if fold:
        params = jl.fold_batchnorm(params)
    model = th.HRNet(cfg)
    if fold:
        tl.fold_batchnorm(model)
    model.load_state_dict(hrnet_state_dict_from_jax(_np_tree(params)), strict=True)
    model.eval()
    x = np.random.default_rng(2).normal(size=(2, 96, 64, 3)).astype(np.float32)
    ref = np.asarray(jh.hrnet_apply(params, jh.tiny_test_config(), jnp.asarray(x),
                                    jnp.float32))
    with torch.no_grad():
        got = model(torch.as_tensor(x.transpose(0, 3, 1, 2).copy()),
                    compute_dtype=torch.float32)
    assert got.shape == (2, 17, 24, 16) and got.dtype == torch.float32
    _close(got.permute(0, 2, 3, 1).numpy(), ref)


def test_fold_batchnorm_matches_jax():
    params = _jitter_bn(jh.hrnet_init(jax.random.PRNGKey(3), jh.tiny_test_config()), 3)
    model = th.HRNet(th.tiny_test_config())
    model.load_state_dict(hrnet_state_dict_from_jax(_np_tree(params)), strict=True)
    tl.fold_batchnorm(model)
    ref = hrnet_state_dict_from_jax(_np_tree(jl.fold_batchnorm(params)))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    tl.fold_batchnorm(model, dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_normalize_image_matches_jax():
    x = np.random.default_rng(4).uniform(size=(2, 8, 6, 3)).astype(np.float32)
    for jdt, tdt in [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]:
        ref = np.asarray(jh.normalize_image(jnp.asarray(x).astype(jdt), 1.0), np.float32)
        got = th.normalize_image(torch.as_tensor(x).to(tdt), 1.0).float().numpy()
        np.testing.assert_array_equal(got, ref)
    u8 = (x * 255).astype(np.uint8)
    np.testing.assert_allclose(th.normalize_image(torch.as_tensor(u8)).numpy(),
                               np.asarray(jh.normalize_image(jnp.asarray(u8))), rtol=1e-6)


def _keys(path):
    with open(path) as f:
        return dict(line.split() for line in f if line.strip())


@pytest.mark.parametrize("cfg_fn,fixture", [
    (th.hrnet_w48_config, "pose_hrnet_w48_384x288.keys.txt"),
    (th.hrnet_w32_config, "pose_hrnet_w32.keys.txt"),
])
def test_hrnet_keys_equal_official(cfg_fn, fixture):
    with torch.device("meta"):
        model = th.HRNet(cfg_fn())
    got = {k: ("x".join(map(str, v.shape)) or "scalar")
           for k, v in model.state_dict().items()}
    assert got == _keys(os.path.join(FIXTURES, fixture))


def test_unported_hrnet_options_raise():
    with pytest.raises(NotImplementedError, match="pack_branch0"):
        th.HRNet(th.HRNetConfig(pack_branch0=True))
    # int8_resident is ported (tests/test_torch_quantize.py runs it)
    cfg = dataclasses.replace(th.tiny_test_config(), int8_resident=True)
    assert th.HRNet(cfg).cfg.int8_resident


def test_yolov3_f32_heads_and_decode_match_jax():
    jcfg, cfg = jy.tiny_yolo_test_config(), ty.tiny_yolo_test_config()
    params = _jitter_bn(jy.yolov3_init(jax.random.PRNGKey(0), jcfg), 5)
    model = ty.YOLOv3(cfg)
    model.load_state_dict(yolo_state_dict_from_jax(_np_tree(params)), strict=True)
    model.eval()
    assert "conv58.conv.bias" in model.state_dict() and "conv0.bn.running_var" in model.state_dict()
    x = np.random.default_rng(6).uniform(size=(3, 64, 64, 3)).astype(np.float32)
    ref = jy.yolov3_apply(params, jcfg, jnp.asarray(x), jnp.float32)
    with torch.no_grad():
        got = model(torch.as_tensor(x.transpose(0, 3, 1, 2).copy()),
                    compute_dtype=torch.float32)
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1).numpy(), np.asarray(r))
    # decode the SAME head values on both sides
    heads = [np.asarray(r) for r in ref]
    bj, sj = jy.decode_detections(jcfg, [jnp.asarray(h) for h in heads])
    bt, st = ty.decode_detections(
        cfg, [torch.as_tensor(h.transpose(0, 3, 1, 2).copy()) for h in heads])
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-7)
    for letterbox in (False, True):
        sj_, oj = jy.yolo_box_mapping(jy.YoloConfig(letterbox=letterbox), (720, 1280))
        st_, ot = ty.yolo_box_mapping(ty.YoloConfig(letterbox=letterbox), (720, 1280))
        np.testing.assert_array_equal(st_.numpy(), np.asarray(sj_))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert ty.conv_in_channels(ty.YoloConfig()) == jy.conv_in_channels(jy.YoloConfig())


def test_detect_people_matches_jax(monkeypatch):
    """Top-K order, NMS keep set and clipped boxes, with the backbone in f32
    on both sides (the JAX package's through yolov3_apply's compute_dtype,
    patched here): boxes agree to 1e-2 px (head rounding goes through
    exp()), scores to 1e-5, and the keep masks exactly."""
    import functools

    monkeypatch.setattr(jy, "yolov3_apply",
                        functools.partial(jy.yolov3_apply, compute_dtype=jnp.float32))
    jcfg, cfg = jy.tiny_yolo_test_config(), ty.tiny_yolo_test_config()
    params = jy.yolov3_init(jax.random.PRNGKey(0), jcfg)
    model = ty.YOLOv3(cfg)
    model.load_state_dict(yolo_state_dict_from_jax(_np_tree(params)), strict=True)
    model.eval()
    x = np.random.default_rng(7).uniform(size=(4, 64, 64, 3)).astype(np.float32)
    bj, sj, vj = jy.detect_people(params, jcfg, jnp.asarray(x), (96, 128))
    with torch.no_grad():
        bt, st, vt = ty.detect_people(model, cfg, torch.as_tensor(x), (96, 128),
                                      torch.float32)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.any()
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-2)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
