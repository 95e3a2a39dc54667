"""int8 serving and the staged API of `tpupose_torch.pipeline.Pipeline`
against `tpupose.pipeline.facade.Pipeline`, on the fixture of
tests/test_clip_pipeline.py (3 views, 4 frames of random uint8 96x128
frames, the tiny configs).

* Serving: the JAX package quantizes its models (`quantize_convs`, at the
  activation ranges the port's `quantize_models` calibrates on one frame
  set), the int8 trees are carried across by `models/convert.py` into the
  modules `quantize_convs` builds, and both packages run their int8 clip paths with
  the networks in f32 (the JAX package's through the `compute_dtype`
  argument, patched in as tests/test_torch_pipeline.py does; the YOLO
  heads planted as there, so boxes do not hang on f32 rounding through
  exp()). Stage A run op by op on both sides gives equal masks and
  keypoints within atol 2e-2 px / rtol 1e-3, the tolerance of
  tests/test_torch_pipeline.py: the int8 convs are exact, so what is left
  is f32 summation order in the float heads and crops, and one int8
  rounding flip where that order moves a value across a rounding boundary.
  The jitted clip programs give equal masks and track decisions.
* The self-check mirrors tests/test_int8_selfcheck.py on the port alone.
* The staged API mirrors tests/test_clip_pipeline.py (clip == per frame,
  clips batch == single clip), and `person_detect` / `person_pose_detect`
  agree with the JAX package in f32 (boxes within 1e-3 px, keypoints within
  the stage A tolerance above).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.models.quantize as jq
import tpupose.models.yolov3 as jy
import tpupose.pipeline.facade as jf
from tpupose.data.synthetic import make_scene
from tpupose.geometry import make_camera_set as j_make_cams
from tpupose.models.hrnet import hrnet_init, tiny_test_config
from tpupose.models.layers import fold_batchnorm as j_fold
from tpupose.tracking.tracker import TrackerConfig as JConfig
import tpupose_torch.models.hrnet as th
import tpupose_torch.models.layers as tl
import tpupose_torch.models.quantize as tq
import tpupose_torch.models.yolov3 as ty
import tpupose_torch.pipeline.facade as tf
import tpupose_torch.tracking.tracker as tt
from tpupose_torch.data.synthetic import make_scene as t_make_scene
from tpupose_torch.geometry import make_camera_set
from tpupose_torch.models.convert import state_dict_from_jax
from tpupose_torch.pipeline import Pipeline

torch.set_num_threads(1)
TRACK = dict(num_cameras=3, max_dets=8, max_tracks=8, max_hyp=16)
ATOL, RTOL = 2e-2, 1e-3


def _clip():
    return np.random.default_rng(0).integers(0, 255, size=(4, 3, 96, 128, 3),
                                             dtype=np.uint8)


def _plant_heads(det_params):
    """As tests/test_torch_pipeline.py: box rows of the detection convs
    zeroed, objectness and class-0 logits at +20."""
    det_params = jax.tree.map(np.array, det_params)
    for i in (58, 66, 74):
        conv = det_params[f"conv{i}"]["conv"]
        rows = conv["bias"].shape[0] // 3
        for a in range(3):
            conv["weight"][..., a * rows:a * rows + 6] = 0.0
            conv["bias"][a * rows:a * rows + 4] = 0.0
            conv["bias"][a * rows + 4:a * rows + 6] = 20.0
    return det_params


def _port_model(module, jax_tree, skip_fn):
    """The JAX tree (float folded, or quantized) loaded strictly into the
    port's folded module, quantized first when the tree is."""
    tl.fold_batchnorm(module)
    flat = state_dict_from_jax(jax.tree.map(np.asarray, jax_tree))
    if not any(k.endswith("weight_q") for k in flat):
        module.load_state_dict(flat)
        return module
    skip = skip_fn(module)
    module = tq.quantize_convs(module, tq.uncalibrated_scales(module, skip), skip)
    module.load_state_dict(flat, strict=True)
    return module


def _pipes(det_params, pose_params, compute_dtype=torch.float32):
    scene = make_scene(num_frames=4, num_cameras=3, num_actors=2, seed=0)
    jpipe = jf.Pipeline(
        cams=j_make_cams(scene.P, scene.K, scene.RT, scene.width, scene.height),
        tracker_cfg=JConfig(**TRACK), det_cfg=jy.tiny_yolo_test_config(),
        det_params=det_params, pose_cfg=tiny_test_config(), pose_params=pose_params)
    tpipe = _port_pipe(det_params, pose_params, compute_dtype)
    return jpipe, tpipe


def _port_pipe(det_params, pose_params, compute_dtype):
    scene = make_scene(num_frames=4, num_cameras=3, num_actors=2, seed=0)
    det_cfg = ty.tiny_yolo_test_config()
    det = _port_model(ty.YOLOv3(det_cfg), det_params,
                      lambda m: tq.yolo_skip_ids(m, det_cfg))
    pose = _port_model(th.HRNet(th.tiny_test_config()), pose_params, tq.hrnet_skip_ids)
    return Pipeline(make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height),
                    tt.TrackerConfig(**TRACK), det_cfg, det, th.tiny_test_config(), pose,
                    device="cpu", compute_dtype=compute_dtype)


def _f32_jax(monkeypatch):
    monkeypatch.setattr(jf, "hrnet_apply",
                        functools.partial(jf.hrnet_apply, compute_dtype=jnp.float32))
    monkeypatch.setattr(jy, "yolov3_apply",
                        functools.partial(jy.yolov3_apply, compute_dtype=jnp.float32))


def _float_trees():
    det = j_fold(_plant_heads(jy.yolov3_init(jax.random.PRNGKey(0), jy.tiny_yolo_test_config())))
    pose = j_fold(hrnet_init(jax.random.PRNGKey(1), tiny_test_config()))
    return det, pose


def _conv_paths(tree, prefix=""):
    """id(conv dict) -> dotted path, for every dict with a 4-D weight."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            if np.ndim(value.get("weight")) == 4:
                out[id(value)] = name
            else:
                out.update(_conv_paths(value, name))
    return out


def _jax_int8_trees(det, pose, images):
    """The JAX package's quantized trees, at activation ranges calibrated
    on `images` by the port's own `quantize_models` (the JAX calibration
    path costs a minute of XLA compiles on the CPU)."""
    tpipe = _port_pipe(det, pose, torch.bfloat16)
    tpipe.quantize_models(images, check_px=None)
    out = []
    for tree, model, skip in ((det, tpipe.detector, jq.yolo_skip_ids(det, jy.tiny_yolo_test_config())),
                              (pose, tpipe.pose_model, jq.hrnet_skip_ids(pose))):
        ranges = {n: float(m.x_scale) * 127.0 for n, m in model.named_modules()
                  if isinstance(m, tl.QuantConv2d)}
        paths = _conv_paths(tree)
        out.append(jq.quantize_convs(tree, {i: ranges[n] for i, n in paths.items() if n in ranges},
                                     skip))
        assert len(ranges) == len(paths) - len(skip)
    return out


def test_int8_process_clip_f32_matches_jax(monkeypatch):
    clip = _clip()
    det_q, pose_q = _jax_int8_trees(*_float_trees(), clip[0])
    assert "weight_q" in pose_q["layer1"]["0"]["conv1"] and "weight" in pose_q["final_layer"]
    _f32_jax(monkeypatch)
    jpipe, tpipe = _pipes(det_q, pose_q)
    assert isinstance(tpipe.pose_model.layer1[0].conv1, tl.QuantConv2d)
    assert isinstance(tpipe.detector.conv58.conv, tl.Conv2d)

    frames = clip.reshape(12, 96, 128, 3)
    ref_d, ref_m = jf._clip_detections(jpipe.det_cfg, jpipe.pose_cfg, jpipe.tracker_cfg,
                                       jpipe.det_params, jpipe.pose_params,
                                       jnp.asarray(frames))
    with torch.no_grad():
        got_d, got_m = tf._clip_detections(
            tpipe.det_cfg, tpipe.pose_cfg, tpipe.tracker_cfg, tpipe.detector,
            tpipe.pose_model, torch.as_tensor(frames), torch.float32)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    assert got_m.any()
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=ATOL, rtol=RTOL)

    outs_j, dets_j, mask_j = jpipe.process_clip(np.arange(4), clip)
    outs_t, dets_t, mask_t = tpipe.process_clip(np.arange(4), clip)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    for field in ("valid", "track_id"):
        np.testing.assert_array_equal(getattr(outs_t, field).numpy(),
                                      np.asarray(getattr(outs_j, field)))


def _self_check_pipe():
    scene = t_make_scene(num_frames=2, num_cameras=3, num_actors=2, seed=0)
    det_cfg, pose_cfg = ty.tiny_yolo_test_config(), th.tiny_test_config()
    gen = torch.Generator().manual_seed(0)
    return Pipeline(
        make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height),
        tt.TrackerConfig(num_cameras=3, max_dets=8), det_cfg,
        tl.fold_batchnorm(ty.yolov3_init(det_cfg, gen)), pose_cfg,
        tl.fold_batchnorm(th.hrnet_init(pose_cfg, gen)), device="cpu")


def _images(n=3):
    return np.random.default_rng(0).integers(0, 255, (n, 120, 160, 3), np.uint8)


def test_self_check_report_produced_and_passes_at_tiny_scale(capsys):
    pipe = _self_check_pipe()
    # the box axis is disabled, as in the JAX package's test: a random-weight
    # tiny YOLO regresses arbitrary boxes from noise
    pipe.quantize_models(_images(), box_lost_gate=1.0)
    out = capsys.readouterr().out
    assert "int8 self-check" in out and "-> ok" in out
    rep = pipe.last_quant_report
    assert set(rep) >= {"kps_median_px", "kps_p95_px", "box_lost_frac"}
    assert np.isfinite(rep["kps_median_px"]) and np.isfinite(rep["box_lost_frac"])
    assert isinstance(pipe.pose_model.layer1[0].conv1, tl.QuantConv2d)
    assert isinstance(pipe.detector.conv0.conv, tl.QuantConv2d)
    # fewer than MIN_CALIB_SAMPLES frames: the warning says so
    assert f"< {tf.MIN_CALIB_SAMPLES}" in out and "WARNING" in out


def test_self_check_raise_mode_fails_loudly():
    pipe = _self_check_pipe()
    with pytest.raises(tq.QuantizationDriftError) as e:
        pipe.quantize_models(_images(), check_px=-1.0, on_drift="raise")
    assert "px" in str(e.value)
    assert isinstance(pipe.pose_model.layer1[0].conv1, tl.Conv2d)  # not served


def test_escalation_and_qat_are_not_ported_yet(capsys):
    """Once a refusal, now the JAX package's behaviour
    (tests/test_int8_selfcheck.py): a failing check escalates to distill-QAT
    and raises with the post-QAT numbers; `qat_steps > 0` serves the
    requantized models; a passing check serves."""
    pipe = _self_check_pipe()
    steps = []
    with pytest.raises(tq.QuantizationDriftError) as e:
        pipe.quantize_models(_images(), check_px=-1.0, on_drift="escalate",
                             escalate_steps=2, qat_batch=2,
                             qat_log=lambda i, v: steps.append(i))
    assert "after distill-QAT" in str(e.value) and "px" in str(e.value)
    out = capsys.readouterr().out
    assert "escalating to label-free distill-QAT (2 steps" in out and "FAILED" in out
    assert steps == [1, 2, 1, 2]  # the detector, then the pose model
    assert pipe.last_quant_report["kps_n"] > 0
    assert isinstance(pipe.pose_model.layer1[0].conv1, tl.Conv2d)  # not served
    # qat_steps > 0: QAT from the start, no escalation, the int8 models served
    pipe.quantize_models(_images(), qat_steps=2, qat_batch=2, check_px=-1.0,
                         on_drift="warn")
    out = capsys.readouterr().out
    assert "escalating" not in out and "FAILED (continuing: on_drift='warn')" in out
    for conv in (pipe.pose_model.layer1[0].conv1, pipe.detector.conv0.conv):
        assert isinstance(conv, tl.QuantConv2d)
    assert not any(isinstance(m, tl.FakeQuantConv2d) for m in pipe.pose_model.modules())
    with pytest.raises(tq.QuantizationDriftError) as e:  # nothing to escalate to
        _self_check_pipe().quantize_models(_images(), qat_steps=1, check_px=-1.0)
    assert "after distill-QAT" not in str(e.value)
    assert "escalating" not in capsys.readouterr().out
    # a passing check serves as in the JAX package
    pipe = _self_check_pipe()
    pipe.quantize_models(_images(8), check_px=1e9, box_lost_gate=1.0)
    out = capsys.readouterr().out
    assert "-> ok" in out and "WARNING: int8 calibration" not in out
    assert isinstance(pipe.pose_model.layer1[0].conv1, tl.QuantConv2d)


def test_self_check_warn_mode_keeps_models(capsys):
    pipe = _self_check_pipe()
    pipe.quantize_models(_images(), check_px=-1.0, on_drift="warn")
    assert "FAILED (continuing: on_drift='warn')" in capsys.readouterr().out
    assert isinstance(pipe.pose_model.layer1[0].conv1, tl.QuantConv2d)


def test_self_check_disabled_with_none():
    pipe = _self_check_pipe()
    pipe.quantize_models(_images(), check_px=None)
    assert not hasattr(pipe, "last_quant_report")
    assert isinstance(pipe.pose_model.layer1[0].conv1, tl.QuantConv2d)


def test_invalid_on_drift_rejected():
    pipe = _self_check_pipe()
    with pytest.raises(ValueError):
        pipe.quantize_models(_images(), on_drift="ignore")


@pytest.mark.parametrize("int8", [False, True])
def test_clip_equals_per_frame(int8):
    clip = _clip()
    det, pose = _float_trees()
    pipes = [_port_pipe(det, pose, torch.bfloat16) for _ in range(2)]
    if int8:
        for p in pipes:
            p.quantize_models(clip[0], check_px=None)
    pipe_a, pipe_b = pipes
    outs_a, dets_a = [], []
    for t in range(4):
        out, dets, _ = pipe_a.process_frame(t, clip[t])
        outs_a.append(out)
        dets_a.append(dets.numpy())
    outs_b, dets_b, _ = pipe_b.process_clip(np.arange(4), clip)
    np.testing.assert_allclose(np.stack(dets_a), dets_b.numpy(), atol=ATOL, rtol=RTOL)
    for t in range(4):
        np.testing.assert_array_equal(outs_a[t].valid.numpy(), outs_b.valid[t].numpy())
    np.testing.assert_allclose(pipe_a.state.hist_pose.numpy(), pipe_b.state.hist_pose.numpy(),
                               atol=1e-4)


def test_clips_nn_batch_equals_single():
    rng = np.random.default_rng(3)
    clips = rng.integers(0, 255, size=(2, 2, 3, 64, 96, 3), dtype=np.uint8)
    pipe = _port_pipe(*_float_trees(), torch.bfloat16)
    ds, ms = pipe.process_clips_nn(clips)
    assert ds.shape[:2] == (2, 2) and ms.shape[:2] == (2, 2)
    d0, m0 = pipe.process_clip_nn(clips[0])
    np.testing.assert_allclose(ds[0].numpy(), d0.numpy(), atol=1e-3)
    np.testing.assert_array_equal(ms[0].numpy(), m0.numpy())


def test_person_detect_and_pose_detect_match_jax(monkeypatch):
    # the JAX staged functions run op by op: under jit XLA's fused crop
    # arithmetic moves keypoints on these random weights (ROADMAP Queue 3)
    _f32_jax(monkeypatch)
    jpipe, tpipe = _pipes(*_float_trees())
    images = _clip()[1]
    with jax.disable_jit():
        bj, sj, vj = jpipe.person_detect(images)
        kj, mj = jpipe.person_pose_detect(images, bj, vj)
    bt, st, vt = tpipe.person_detect(images)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.any()
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-3, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    kt, mt = tpipe.person_pose_detect(images, torch.as_tensor(np.array(bj)), vt)
    assert kt.shape == (3, bt.shape[1], 17, 3) and mt is vt
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL, rtol=RTOL)
