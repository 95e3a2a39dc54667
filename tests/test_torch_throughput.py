"""The port's multi-stream clip function (`tpupose_torch.parallel.
throughput`) on the tiny configs: S = 3 streams of F = 4 frames of 3 random
uint8 96x128 views, the JAX package's random weights carried across by
`models/convert.py`.

The weights are the port's random init from a seed, handed to the JAX
package as its nested HWIO trees (`_jax_tree`, the inverse of
`state_dict_from_jax`): JAX's own init of the tiny nets takes half a
minute op by op on the CPU.

* Stage A is per image, so chunking it is exact: every output and the
  final states equal the unchunked run's bit for bit.
* Stage B of each stream equals `track_clip` on that stream's stage-A
  detections: discrete fields exactly, pose3d within 1e-5 m (a batched
  reduction may sum in another order).
* Against JAX's `make_multistream_clip_fn` on the served bf16 path: the
  FrameOutputs and final states have the JAX shapes, the tracker's
  decisions (valid, track ids) are equal, and the stage-A masks equal
  those of the JAX stage A on the same images, with finite keypoints.
  The keypoints themselves are not held here: stage A is the facade's
  `_clip_detections`, which tests/test_torch_pipeline.py holds to JAX (in
  f32 within atol 2e-2 / rtol 1e-3; in bf16, 90% of the values, a share
  that depends on the random weights: 94.7% on that test's JAX-made
  weights, 83% on these, ROADMAP.md Queue 3's first entry).
"""
import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.pipeline.facade as jf
from tpupose.data.synthetic import make_scene
from tpupose.geometry import make_camera_set as j_make_cams
from tpupose.models.hrnet import tiny_test_config
from tpupose.models.yolov3 import tiny_yolo_test_config
from tpupose.parallel.streams import broadcast_cameras as j_broadcast
from tpupose.parallel.streams import init_multistream_state as j_init_ms
from tpupose.parallel.throughput import _auto_chunk as j_auto_chunk
from tpupose.parallel.throughput import make_multistream_clip_fn as j_make_clip_fn
from tpupose.tracking.tracker import TrackerConfig as JConfig
import tpupose_torch.models.hrnet as th
import tpupose_torch.models.yolov3 as ty
import tpupose_torch.parallel.throughput as tp
import tpupose_torch.tracking.tracker as tt
from tpupose_torch.geometry import CameraSet
from tpupose_torch.models.convert import state_dict_from_jax
from tpupose_torch.models.layers import fold_batchnorm
from tpupose_torch.models.quantize import (
    hrnet_skip_ids,
    quantize_convs,
    uncalibrated_scales,
    yolo_skip_ids,
)
from tpupose_torch.parallel import broadcast_cameras, init_multistream_state

torch.set_num_threads(1)
S, F, C, H, W = 3, 4, 3, 96, 128
TRACK = dict(num_cameras=C, max_dets=8, max_tracks=8, max_hyp=16)


def _jax_tree(model):
    """The module's weights as the JAX package's parameter tree."""
    tree = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = t.numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def _plant_heads(det):
    """A copy of the detector whose three detection convs give every
    candidate objectness and class-0 logits of +20 and the anchor's box:
    every candidate is valid whatever the backbone computes."""
    det = copy.deepcopy(det)
    with torch.no_grad():
        for i in (58, 66, 74):
            conv = getattr(det, f"conv{i}").conv
            rows = conv.bias.shape[0] // 3
            for a in range(3):
                conv.weight[a * rows:a * rows + 6] = 0.0
                conv.bias[a * rows:a * rows + 4] = 0.0
                conv.bias[a * rows + 4:a * rows + 6] = 20.0
    return det


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(num_frames=1, num_cameras=C, num_actors=2, seed=0)
    rig = j_make_cams(scene.P, scene.K, scene.RT, W, H)
    gen = torch.Generator().manual_seed(0)
    det = ty.yolov3_init(ty.tiny_yolo_test_config(), gen)
    pose = th.hrnet_init(th.tiny_test_config(), gen)
    det_params, pose_params = _jax_tree(det), _jax_tree(pose)
    for model, tree in ((det, det_params), (pose, pose_params)):
        for k, v in state_dict_from_jax(tree).items():
            assert torch.equal(v, model.state_dict()[k]), k
    clip = np.random.default_rng(0).integers(0, 255, size=(S, F, C, H, W, 3), dtype=np.uint8)
    fids = np.arange(S * F, dtype=np.int32).reshape(S, F)
    cams = CameraSet(*(torch.as_tensor(np.array(x)) for x in rig))
    return dict(rig=rig, det_params=det_params, pose_params=pose_params,
                det=det.eval(), pose=pose.eval(), clip=clip, fids=fids, cams=cams)


def _run(setup, det, pose, monkeypatch=None, **kw):
    """The port's clip function; with `monkeypatch`, also the stage-A
    detections it made, chunk by chunk."""
    chunks = []
    if monkeypatch is not None:
        inner = tp._clip_detections

        def recording(*args):
            out = inner(*args)
            chunks.append(out)
            return out
        monkeypatch.setattr(tp, "_clip_detections", recording)
    tcfg = tt.TrackerConfig(**TRACK)
    fn = tp.make_multistream_clip_fn(ty.tiny_yolo_test_config(), th.tiny_test_config(),
                                     tcfg, **kw)
    states, outs = fn(det, pose, broadcast_cameras(setup["cams"], S),
                      init_multistream_state(tcfg, S, "cpu"),
                      torch.as_tensor(setup["clip"]), torch.as_tensor(setup["fids"]))
    return states, outs, chunks


def _streams_equal_track_clip(setup, states, outs, chunks):
    """Stage B of each stream against `track_clip` on its own detections."""
    tcfg = tt.TrackerConfig(**TRACK)
    dets = torch.cat([d.reshape(S, -1, C, 8, 17, 3) for d, _ in chunks], dim=1)
    mask = torch.cat([m.reshape(S, -1, C, 8) for _, m in chunks], dim=1)
    assert dets.shape[1] == F and mask.any()
    for s in range(S):
        final, ref = tt.track_clip(tcfg, setup["cams"], tt.init_state(tcfg, "cpu"),
                                   dets[s], mask[s], torch.as_tensor(setup["fids"][s]))
        for field in ("valid", "track_id", "n_views", "pose2d_now", "pose2d"):
            torch.testing.assert_close(getattr(outs, field)[s], getattr(ref, field),
                                       rtol=0, atol=0)
        torch.testing.assert_close(outs.pose3d[s], ref.pose3d, rtol=0, atol=1e-5)
        for a, b in zip(states, final):
            if not torch.is_floating_point(b):
                torch.testing.assert_close(a[s], b, rtol=0, atol=0)
    return dets, mask


@pytest.mark.parametrize("s", [1, 2, 3, 8])
def test_auto_chunk_equals_jax(s):
    for f in (1, 2, 4, 7, 16, 48, 128):
        for c in (1, 3, 5):
            assert tp._auto_chunk(s, f, c) == j_auto_chunk(s, f, c), (s, f, c)


def test_chunked_equals_unchunked_and_streams_equal_track_clip(setup, monkeypatch):
    with torch.no_grad():
        st_w, out_w, _ = _run(setup, setup["det"], setup["pose"], chunk_frames=F)
        st_c, out_c, chunks = _run(setup, setup["det"], setup["pose"], monkeypatch,
                                   chunk_frames=2)
    assert len(chunks) == 2 and out_c.pose3d.shape == (S, F, 8, 17, 3)
    for a, b in zip(tuple(out_w) + tuple(st_w), tuple(out_c) + tuple(st_c)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _streams_equal_track_clip(setup, st_c, out_c, chunks)


def test_int8_models_run_the_same_path(setup, monkeypatch):
    # planted heads, so that uncalibrated int8 backbones still give boxes
    det_f = fold_batchnorm(_plant_heads(setup["det"]))
    pose_f = fold_batchnorm(copy.deepcopy(setup["pose"]))
    det_q = quantize_convs(det_f, uncalibrated_scales(
        det_f, yolo_skip_ids(det_f, ty.tiny_yolo_test_config())))
    pose_q = quantize_convs(pose_f, uncalibrated_scales(pose_f, hrnet_skip_ids(pose_f)))
    with torch.no_grad():
        states, outs, chunks = _run(setup, det_q, pose_q, monkeypatch)
    assert len(chunks) == 1  # _auto_chunk(3, 4, 3) takes all 4 frames at once
    dets, _ = _streams_equal_track_clip(setup, states, outs, chunks)
    assert torch.isfinite(dets).all()


def _jax_multistream(setup, det_params):
    """JAX's multistream clip function, and its stage A alone on the same
    images."""
    jcfg = JConfig(**TRACK)
    clip = jnp.asarray(setup["clip"])
    states, outs = j_make_clip_fn(tiny_yolo_test_config(), tiny_test_config(), jcfg)(
        det_params, setup["pose_params"], j_broadcast(setup["rig"], S),
        j_init_ms(jcfg, S), clip, jnp.asarray(setup["fids"]))
    stage_a = functools.partial(jf._clip_detections, tiny_yolo_test_config(),
                                tiny_test_config(), jcfg)
    dets, mask = jax.jit(stage_a)(
        det_params, setup["pose_params"], clip.reshape(S * F * C, H, W, 3))
    return states, outs, np.asarray(dets), np.asarray(mask)


def test_matches_jax_multistream_clip_fn(setup, monkeypatch):
    j_states, j_outs, ref_d, ref_m = _jax_multistream(setup, setup["det_params"])
    with torch.no_grad():
        states, outs, chunks = _run(setup, setup["det"], setup["pose"], monkeypatch)
    (got_d, got_m), = chunks
    np.testing.assert_array_equal(got_m.numpy(), ref_m)
    dt = got_d.numpy()
    assert got_m.any() and np.isfinite(dt).all()
    for got, ref in zip(tuple(outs) + tuple(states), tuple(j_outs) + tuple(j_states)):
        assert tuple(got.shape) == tuple(ref.shape)
    for field in ("valid", "track_id"):
        np.testing.assert_array_equal(getattr(outs, field).numpy(),
                                      np.asarray(getattr(j_outs, field)))
