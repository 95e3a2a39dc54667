"""tpupose_torch.ops.packing (width-packed HRNet branch 0) and
`Pipeline.pack_models` against tpupose.ops.packing.

Inputs are made with numpy from a seed and given to both packages; the
JAX package's trees cross over through `models/convert.py`.

Tolerances and why:
* `pack_width`, `unpack_width` and the packed kernels equal the JAX
  functions exactly after the NHWC <-> NCHW / HWIO <-> OIHW transposes:
  they move values and write zeros.
* A packed conv equals its unpacked form exactly in int8 (int32 sums, and
  the structural zeros add nothing), within rtol / atol 1e-5 in f32 (the
  sums run over twice the taps, half of them zero, in another order).
* The packed tiny HRNet, f32 and int8, within 1e-4 of the JAX package's
  packed `hrnet_apply` on the same weights: the JAX package's own bound
  for packed against unpacked (tests/test_packing.py); f32 sums differ in
  order between the frameworks.
* `Pipeline.pack_models`: equal masks and detections within 2e-2, the JAX
  package's own check of the same switch.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.models.hrnet as jh
import tpupose.models.layers as jl
import tpupose.models.quantize as jq
import tpupose.ops.packing as jp
import tpupose_torch.models.hrnet as th
import tpupose_torch.models.layers as tl
import tpupose_torch.models.quantize as tq
import tpupose_torch.ops.packing as tp
from tpupose_torch.models.convert import hrnet_state_dict_from_jax

torch.set_num_threads(1)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(w):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_pack_width_and_weight_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, size=(2, 5, 8, 3)).astype(dtype)
    want = np.asarray(jp.pack_width(jnp.asarray(x)))
    got = tp.pack_width(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), want)
    np.testing.assert_array_equal(_nhwc(tp.unpack_width(got)), x)
    w = rng.integers(-127, 128, size=(3, 3, 4, 6)).astype(dtype)  # HWIO
    np.testing.assert_array_equal(tp.pack_conv_weight_width(_oihw(w)).numpy(),
                                  _oihw(jp.pack_conv_weight_width(w)).numpy())
    with pytest.raises(ValueError, match="even"):
        tp.pack_width(_nchw(x[:, :, :7]))
    with pytest.raises(ValueError, match="3-wide"):
        tp.pack_conv_weight_width(_oihw(w[:, :1]))


def _conv_and_input(seed, quantized):
    rng = np.random.default_rng(seed)
    cin = cout = 6
    conv = tl.Conv2d(cin, cout, 3, bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(rng.standard_normal((cout, cin, 3, 3)), dtype=torch.float32))
        conv.bias.copy_(torch.as_tensor(rng.standard_normal(cout), dtype=torch.float32))
    x = torch.as_tensor(rng.standard_normal((2, cin, 7, 10)), dtype=torch.float32)
    if quantized:
        conv = tq.quantize_convs(torch.nn.Sequential(conv), {conv: float(x.abs().max())})[0]
    return conv, x


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_packed_conv_matches_unpacked(quantized):
    conv, x = _conv_and_input(1, quantized)
    packed = tp.pack_conv_module_width(conv)
    assert isinstance(packed, type(conv))
    with torch.no_grad():
        want = conv(x)
        got = tp.unpack_width(packed(tp.pack_width(x)))
    if quantized:
        assert torch.equal(packed.x_scale, conv.x_scale)
        assert torch.equal(packed.w_scale, conv.w_scale.repeat(2))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _tiny(seed):
    cfg = jh.tiny_test_config()
    params = jl.fold_batchnorm(jh.hrnet_init(jax.random.PRNGKey(seed), cfg))
    model = tl.fold_batchnorm(th.HRNet(th.tiny_test_config()))
    model.load_state_dict(hrnet_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return cfg, params, model


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_packed_hrnet_matches_jax(quantized):
    """The port's packed HRNet (`pack_hrnet_branch0` of the converted
    model), and the JAX package's packed tree converted and loaded into the
    packed skeleton, against the JAX package's packed forward."""
    cfg, params, model = _tiny(3)
    rng = np.random.default_rng(4)
    x = rng.random((2, *cfg.input_size, 3)).astype(np.float32)
    if quantized:
        params = jq.quantize_hrnet(params, cfg, jnp.asarray(x))
        skip = tq.hrnet_skip_ids(model)
        model = tq.quantize_convs(model, tq.uncalibrated_scales(model, skip), skip)
        model.load_state_dict(hrnet_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    jpacked = jp.pack_hrnet_branch0(params)
    pcfg = dataclasses.replace(cfg, pack_branch0=True)
    ref = np.asarray(jh.hrnet_apply(jpacked, pcfg, jnp.asarray(x), compute_dtype=jnp.float32))

    packed = tp.pack_hrnet_branch0(model)
    assert packed.cfg.pack_branch0 and not model.cfg.pack_branch0
    sd = hrnet_state_dict_from_jax(jax.tree.map(np.asarray, jpacked))
    for k, v in packed.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with torch.device("meta"):
        skeleton = tl.fold_batchnorm(th.HRNet(packed.cfg))
        if quantized:
            skip = tq.hrnet_skip_ids(skeleton)
            skeleton = tq.quantize_convs(skeleton, tq.uncalibrated_scales(skeleton, skip), skip)
    skeleton.load_state_dict(sd, strict=True, assign=True)
    with torch.no_grad():
        for net in (packed, skeleton):
            got = _nhwc(net(_nchw(x), torch.float32))
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        unpacked = _nhwc(model(_nchw(x), torch.float32))
    if quantized:  # the same int32 sums: packing changes nothing
        np.testing.assert_array_equal(_nhwc(packed(_nchw(x), torch.float32)), unpacked)


def test_pipeline_pack_models_keeps_detections():
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.models.yolov3 import tiny_yolo_test_config, yolov3_init
    from tpupose_torch.pipeline.facade import Pipeline
    from tpupose_torch.tracking.tracker import TrackerConfig

    scene = make_scene(num_frames=1, num_cameras=3, num_actors=2, seed=0)
    h, w = 96, 128
    rig = make_camera_set(scene.P, scene.K, scene.RT, w, h)
    gen = torch.Generator().manual_seed(0)
    detector = tl.fold_batchnorm(yolov3_init(tiny_yolo_test_config(), gen))
    pose = tl.fold_batchnorm(th.hrnet_init(th.tiny_test_config(), gen))
    tcfg = TrackerConfig(num_cameras=3, max_dets=8, max_tracks=8, max_hyp=16)
    images = np.random.default_rng(2).integers(0, 255, size=(3, h, w, 3), dtype=np.uint8)
    pipe = Pipeline(rig, tcfg, tiny_yolo_test_config(), detector, th.tiny_test_config(),
                    pose, device="cpu")
    _, dets_a, mask_a = pipe.process_frame(0, images)

    pipe.track_restart()
    pipe.pack_models()
    assert pipe.pose_cfg.pack_branch0 and pipe.pose_model.cfg.pack_branch0
    assert not pose.cfg.pack_branch0  # the unpacked model is left as it was
    _, dets_b, mask_b = pipe.process_frame(0, images)
    assert torch.equal(mask_a, mask_b) and bool(mask_a.any())
    torch.testing.assert_close(dets_b, dets_a, rtol=0, atol=2e-2)
    packed = pipe.pose_model
    pipe.pack_models()  # idempotent
    assert pipe.pose_model is packed


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_pack_width_of_channels_last_is_a_view_matching_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, size=(2, 5, 8, 3)).astype(dtype)  # NHWC
    want = np.asarray(jp.pack_width(jnp.asarray(x)))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    got = tp.pack_width(xt)
    assert got.data_ptr() == xt.data_ptr()
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), want)
    np.testing.assert_array_equal(_nhwc(tp.pack_width(_nchw(x))), want)  # the NCHW copy
    back = tp.unpack_width(got)
    assert back.data_ptr() == xt.data_ptr() and torch.equal(back, xt)
    assert back.is_contiguous(memory_format=torch.channels_last)
