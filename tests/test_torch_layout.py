"""Stage A in the JAX package's channels-last layout (`tpupose_torch.ops.layout`).

`Pipeline` restrides its models' conv weights once
(`models.layers.to_channels_last`) and hands the networks channels-last
views of its NHWC images and crops; every layer follows its input's layout,
so stage A runs NHWC from the frames to the heatmaps, as the JAX package's
does, and an NCHW input still runs NCHW. On the CPU the int8 convs run
their plain versions; the kernels' channels-last modes are held against the
same plain versions on the card (chip_smoke.py phase 4).

Tolerances and why:
* The tiny HRNet and YOLOv3 in channels-last against NCHW, f32: within a
  relative norm of 1e-5 (the CPU's convolutions sum in another order per
  layout: measured 4e-7 to 9e-7, each layout as far from an f64 run as the
  other, so elementwise bounds fail where outputs cross zero), and the
  outputs keep the input's layout. An NCHW input on the restrided model
  gives the NCHW model's outputs exactly.
* `_clip_detections` channels-last against the JAX package's, f32: the
  tolerance of tests/test_torch_pipeline.py (atol 2e-2 px, rtol 1e-3, equal
  masks), on its fixture.
* Conv inputs on `Pipeline`'s path: none NCHW, after construction,
  `quantize_models` and `pack_models` (exact counts).
* int8 resident blocks: channels-last torch.equal to the NCHW run and to the
  JAX package's NHWC blocks (int32 sums are exact); against the generic int8
  block within chip_smoke.py phase 7's bound (one inter-conv code of
  difference at most).
"""
import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.models.quantize as jq
import tpupose.models.yolov3 as jy
import tpupose.pipeline.facade as jf
from tpupose.models.hrnet import hrnet_init, tiny_test_config
import tpupose_torch.models.hrnet as th
import tpupose_torch.models.layers as tl
import tpupose_torch.models.quantize as tq
import tpupose_torch.models.yolov3 as ty
import tpupose_torch.pipeline.facade as tf
from tpupose_torch.ops.layout import is_channels_last, memory_format_of
from tests.test_torch_pipeline import _clip, _pipes, _plant_heads, _scene
from tests.test_torch_quantize import _folded_block

torch.set_num_threads(1)
CL = torch.channels_last


def _cl(x):
    return x.contiguous(memory_format=CL)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_is_channels_last():
    x = torch.zeros(2, 4, 3, 5)
    assert not is_channels_last(x) and memory_format_of(x) == torch.contiguous_format
    assert is_channels_last(_cl(x)) and memory_format_of(_cl(x)) == CL
    assert not is_channels_last(torch.zeros(2, 4, 3, 10)[..., ::2])
    # both layouts at once (H = W = 1): NCHW, today's code
    assert not is_channels_last(_cl(torch.zeros(2, 4, 1, 1)))


def _tiny_models():
    gen = torch.Generator().manual_seed(0)
    det = tl.fold_batchnorm(ty.yolov3_init(ty.tiny_yolo_test_config(), gen))
    pose = tl.fold_batchnorm(th.hrnet_init(th.tiny_test_config(), gen))
    return det, pose


@pytest.mark.parametrize("net", ["hrnet", "yolov3"])
def test_network_channels_last_matches_nchw(net):
    det, pose = _tiny_models()
    model, shape = (pose, (3, 3, 96, 64)) if net == "hrnet" else (det, (3, 3, 64, 64))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    model_cl = tl.to_channels_last(copy.deepcopy(model))
    assert all(m.weight.is_contiguous(memory_format=CL) for m in model_cl.modules()
               if isinstance(m, torch.nn.Conv2d))
    with torch.no_grad():
        ref = model(x, torch.float32)
        got = model_cl(_cl(x), torch.float32)
        # an NCHW input on the restrided model still runs NCHW
        nchw = model_cl(x, torch.float32)
    for g, r, n in zip(*(o if isinstance(o, list) else [o] for o in (got, ref, nchw))):
        assert is_channels_last(g) and not is_channels_last(r) and n.is_contiguous()
        assert _rel(g, r) <= 1e-5
        assert torch.equal(n, r)


def _conv_input_layouts(models):
    """Forward pre-hooks on every conv of `models` recording whether each
    input was channels-last; returns (records, remove)."""
    seen, hooks = [], []

    def hook(mod, args):
        seen.append(args[0].is_contiguous(memory_format=CL))

    for model in models:
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, tl.QuantConv2d)):
                hooks.append(m.register_forward_pre_hook(hook))
    return seen, lambda: [h.remove() for h in hooks]


def test_clip_detections_channels_last_match_jax(monkeypatch):
    monkeypatch.setattr(jf, "hrnet_apply",
                        functools.partial(jf.hrnet_apply, compute_dtype=jnp.float32))
    monkeypatch.setattr(jy, "yolov3_apply",
                        functools.partial(jy.yolov3_apply, compute_dtype=jnp.float32))
    scene, clip = _scene(), _clip()
    det_params = _plant_heads(jy.yolov3_init(jax.random.PRNGKey(0), jy.tiny_yolo_test_config()))
    pose_params = hrnet_init(jax.random.PRNGKey(1), tiny_test_config())
    jpipe, tpipe = _pipes(scene, det_params, pose_params, torch.float32)
    frames = clip.reshape(12, 96, 128, 3)
    ref_d, ref_m = jf._clip_detections(jpipe.det_cfg, jpipe.pose_cfg, jpipe.tracker_cfg,
                                       det_params, pose_params, jnp.asarray(frames))
    seen, remove = _conv_input_layouts([tpipe.detector, tpipe.pose_model])
    try:
        with torch.no_grad():
            got_d, got_m = tf._clip_detections(
                tpipe.det_cfg, tpipe.pose_cfg, tpipe.tracker_cfg, tpipe.detector,
                tpipe.pose_model, torch.as_tensor(frames), torch.float32)
    finally:
        remove()
    assert seen and all(seen)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    assert got_m.any()
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=2e-2, rtol=1e-3)


@pytest.mark.parametrize("stage", ["constructed", "quantized", "quantized_packed"])
def test_pipeline_convs_see_no_nchw_input(stage, capsys):
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking.tracker import TrackerConfig

    det, pose = _tiny_models()
    scene = make_scene(num_frames=1, num_cameras=2, num_actors=1, seed=0)
    pipe = Pipeline(make_camera_set(scene.P, scene.K, scene.RT, 128, 96),
                    TrackerConfig(num_cameras=2, max_dets=4, max_tracks=4, max_hyp=8),
                    ty.tiny_yolo_test_config(), det, th.tiny_test_config(), pose,
                    device="cpu")
    clip = np.random.default_rng(2).integers(0, 255, size=(2, 2, 96, 128, 3), dtype=np.uint8)
    if stage != "constructed":
        pipe.quantize_models(clip[:, 0], on_drift="warn")
    if stage == "quantized_packed":
        pipe.pack_models()
    convs = [m for model in (pipe.detector, pipe.pose_model) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(m.weight.is_contiguous(memory_format=CL) for m in convs)
    quantized = [m for model in (pipe.detector, pipe.pose_model) for m in model.modules()
                 if isinstance(m, tl.QuantConv2d)]
    assert bool(quantized) == (stage != "constructed")
    assert all(m.weight_q.is_contiguous() for m in quantized)
    seen, remove = _conv_input_layouts([pipe.detector, pipe.pose_model])
    try:
        dets, mask = pipe.process_clip_nn(clip)
    finally:
        remove()
    assert len(seen) > 50 and all(seen), f"{seen.count(False)} of {len(seen)} conv inputs NCHW"
    assert torch.isfinite(dets).all()


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_resident_blocks_channels_last(kind):
    rng = np.random.default_rng(4)
    c = 16
    if kind == "basic":
        block_t = th.BasicBlock(c, c)
        convs = {"conv1": (c, c, 3), "conv2": (c, c, 3)}
        fn_j, fn_t = jq.quantized_basic_block, tq.quantized_basic_block
    else:
        block_t = th.Bottleneck(4 * c, c)
        convs = {"conv1": (4 * c, c, 1), "conv2": (c, c, 3), "conv3": (c, 4 * c, 1)}
        fn_j, fn_t = jq.quantized_bottleneck, tq.quantized_bottleneck
    block_j = {name: {"weight": jnp.asarray(rng.standard_normal((k, k, ci, co)) * 0.2,
                                            jnp.float32),
                      "bias": jnp.asarray(rng.standard_normal(co) * 0.1, jnp.float32)}
               for name, (ci, co, k) in convs.items()}
    for i in range(len(convs)):
        block_j[f"bn{i + 1}"] = {}
    scales = {name: float(rng.uniform(2.0, 4.0)) for name in convs}
    qj, qt = _folded_block(block_j, block_t, scales)
    x = rng.standard_normal((2, 8, 8, convs["conv1"][0])).astype(np.float32)

    def l1(conv):
        return float((conv.weight_q.float().abs() * conv.w_scale[:, None, None, None])
                     .sum(dim=(1, 2, 3)).max())

    if kind == "basic":
        bound = 3 * float(qt.conv2.x_scale) * l1(qt.conv2)
    else:
        bound = 3 * (float(qt.conv2.x_scale) * l1(qt.conv2) + float(qt.conv3.x_scale)) * l1(qt.conv3)
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(fn_j(qj, jnp.asarray(x, dt_j)).astype(jnp.float32))
        with torch.no_grad():
            got = fn_t(qt, _cl(_nchw(x).to(dt_t)))
            nchw = fn_t(qt, _nchw(x).to(dt_t))
            generic = qt(_cl(_nchw(x).to(dt_t)), resident=False)
        assert is_channels_last(got) and is_channels_last(generic) and nchw.is_contiguous()
        assert torch.equal(got, nchw)
        np.testing.assert_array_equal(_nhwc(got.float()), ref)
        err = float((got.float() - generic.float()).abs().max())
        assert err <= bound, (err, bound)


def test_quantized_state_dict_and_bundle_bytes_do_not_see_the_layout(tmp_path):
    from tpupose_torch.cli.convert import write_bundle

    det, pose = _tiny_models()
    crops = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 3, 96, 64)),
                            dtype=torch.float32)
    # the same activation scales for both layouts (calibration itself sees
    # the layouts' f32 rounding)
    ranges = {name: 1.0 + 0.01 * i for i, (name, m) in enumerate(pose.named_modules())
              if isinstance(m, tl.Conv2d)}
    pose_cl = tl.to_channels_last(copy.deepcopy(pose))
    q_nchw, q_cl = (tq.quantize_convs(m, {m.get_submodule(k): v for k, v in ranges.items()})
                    for m in (pose, pose_cl))
    sd_n, sd_c = q_nchw.state_dict(), q_cl.state_dict()
    assert sd_n.keys() == sd_c.keys()
    for k in sd_n:
        assert torch.equal(sd_n[k], sd_c[k]), k
        if k.endswith("weight_q"):
            assert sd_c[k].is_contiguous(), k
    for name, model in (("nchw", q_nchw), ("cl", tl.to_channels_last(q_cl))):
        write_bundle(tmp_path / name, ty.tiny_yolo_test_config(), det,
                     th.tiny_test_config(), model, quantized=True)
    for f in ("det.pt", "pose.pt"):
        saved = [torch.load(tmp_path / d / f) for d in ("nchw", "cl")]
        assert saved[0].keys() == saved[1].keys()
        for k in saved[0]:
            assert saved[0][k].stride() == saved[1][k].stride(), k
            assert torch.equal(saved[0][k], saved[1][k]), k
    # a channels-last model's state_dict loads into an NCHW one, which then
    # computes as the NCHW model does
    fresh = copy.deepcopy(q_nchw)
    fresh.load_state_dict(q_cl.state_dict(), strict=True)
    with torch.no_grad():
        assert torch.equal(fresh(crops, torch.float32), q_nchw(crops, torch.float32))


def test_packed_channels_last_hrnet_matches_nchw():
    from tpupose_torch.ops.packing import pack_hrnet_branch0

    _, pose = _tiny_models()
    crops = torch.as_tensor(np.random.default_rng(6).standard_normal((2, 3, 96, 64)),
                            dtype=torch.float32)
    packed = pack_hrnet_branch0(pose)
    packed_cl = tl.to_channels_last(copy.deepcopy(packed))
    with torch.no_grad():
        ref = packed(crops, torch.float32)
        got = packed_cl(_cl(crops), torch.float32)
        unpacked = pose(crops, torch.float32)
    assert is_channels_last(got)
    assert _rel(got, ref) <= 1e-5 and _rel(got, unpacked) <= 1e-4
    # int8: packed channels-last equals unpacked NCHW exactly
    q = tq.quantize_hrnet(pose, th.tiny_test_config(), crops, compute_dtype=torch.float32)
    qp = tl.to_channels_last(pack_hrnet_branch0(q))
    with torch.no_grad():
        assert _rel(qp(_cl(crops), torch.float32), q(crops, torch.float32)) <= 1e-5
