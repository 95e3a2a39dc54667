"""The port's parallel modules (`tpupose_torch.parallel.{mesh,multihost}`,
`shard_streams` and the mesh step, `models.train.make_sharded_train_step`)
in four real processes over gloo, against the port in one process and the
JAX package on its 8-device virtual CPU mesh.

One launch serves every case: `tests/torch_parallel_worker.py` (the port
alone) runs as four ranks forming a (data=2, model=2) mesh over a
`file://` rendezvous under `tmp_path`, with its inputs made here from
seeds with numpy and its results written back per rank as `.npz`; every
wait has a timeout. Meanwhile this process computes the references.

Tolerances and why:
* 8 streams of different scenes, 6 frames: track ids exactly equal to the
  port's single-process step and to JAX's sharded `make_multistream_step_fn`,
  `hist_pose` within atol 1e-5 (tests/test_parallel.py's rule; against JAX
  XLA and torch sum in other orders).
* The tiny multi-stream clip over sharded streams: equal to the unsharded
  clip bit for bit (stage A is per image, stage B per stream).
* `make_sharded_train_step` with synchronized train-mode BN: the loss within
  rtol 1e-5 of the single-process `heatmap_loss` and of JAX's
  `make_sharded_train_step` at (2, 2) (the bound JAX holds itself to in
  tests/test_parallel.py); the gathered parameters after one step within
  rtol 1e-5 of the single-process `make_train_step`, plus atol 1e-2 x lr:
  Adam's first step moves an entry by lr * g / (|g| + eps), so where a
  gradient is near eps the f32 sums of two half batches (against one
  whole batch) move the step itself (measured: one entry of 202 tensors,
  6.0e-7 off, rtol 1.2e-5, with two all-reduces a BN; with one all-gather
  a BN the worst entry is still one whose f32 gradient, sharded or not, is
  mostly rounding, and it moves with the synchronized BN's order of f32
  sums).
* The sharded step's captured path (on the CPU its body at every call)
  against `step.eager` from the same weights, with capturable foreach
  AdamW as the card runs it: 6 steps bit for bit (losses, local tensors,
  `.grad`, AdamW state), the same aten and c10d ops every step after the
  warm-ups, no host read; over a one-rank group of each rank alone, the
  (1, 1) mesh, bit for bit against `make_train_step` (the merge over one
  rank is the identity).
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.models.hrnet as jh
import tpupose.models.train as jt
import tpupose.parallel as jp
from tpupose.data.synthetic import make_scene
from tpupose.geometry import make_camera_set as j_make_cams
from tpupose.tracking.tracker import TrackerConfig as JConfig
import tpupose_torch.models.hrnet as th
import tpupose_torch.models.train as tt
import tpupose_torch.models.yolov3 as ty
from tpupose_torch.geometry import CameraSet, make_camera_set
from tpupose_torch.parallel import (
    conv_param_sharding,
    data_sharding,
    init_multistream_state,
    make_mesh,
    make_multistream_clip_fn,
    make_multistream_step_fn,
    multihost,
    replicated,
    shard_batch,
    shard_streams,
)
from tpupose_torch.parallel.mesh import Mesh
from tpupose_torch.tracking.tracker import TrackerConfig
from tests.torch_parallel_worker import recorded_clip

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
WORLD, DATA, MODEL = 4, 2, 2
STEP_CAPS = dict(num_cameras=4, max_tracks=8, max_dets=6, max_hyp=16)
STEP_STREAMS, STEP_FRAMES = 8, 6
CLIP_CAPS = dict(num_cameras=3, max_dets=8, max_tracks=8, max_hyp=16)
CLIP_S, CLIP_F, CLIP_C, CLIP_H, CLIP_W = 4, 4, 3, 96, 128
BATCH, LR = 8, 1e-4
TIMEOUT_S = 240


def _jax_tree(model):
    """A port module's weights as the JAX package's nested HWIO tree."""
    tree = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        arr = t.detach().numpy().copy()  # a copy: the step updates the module
        node[leaf] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
    return tree


def _rig_arrays(scenes, prefix):
    return {prefix + "P": np.stack([s.P for s in scenes]).astype(np.float32),
            prefix + "K": np.stack([s.K for s in scenes]).astype(np.float32),
            prefix + "RT": np.stack([s.RT for s in scenes]).astype(np.float32)}


def _inputs():
    """The workers' inputs, from seeds."""
    scenes = [make_scene(num_frames=STEP_FRAMES, num_cameras=4, num_actors=2, noise_px=0.8,
                         seed=11 + s) for s in range(STEP_STREAMS)]
    assert len({(s.width, s.height) for s in scenes}) == 1
    dets = np.zeros((STEP_FRAMES, STEP_STREAMS, 4, 6, 17, 3), np.float32)
    mask = np.zeros((STEP_FRAMES, STEP_STREAMS, 4, 6), bool)
    for s, scene in enumerate(scenes):
        for t in range(STEP_FRAMES):
            for c, d in enumerate(scene.detections_list(t)):
                dets[t, s, c, :len(d)] = d
                mask[t, s, c, :len(d)] = True
    clip_scene = make_scene(num_frames=1, num_cameras=CLIP_C, num_actors=2, seed=0)
    cfg = jh.tiny_test_config()
    imgs, kps = jt.blob_localization_batch(np.random.default_rng(3), cfg, BATCH)
    images = np.ascontiguousarray(np.asarray(imgs).transpose(0, 3, 1, 2))
    targets, weights = tt.gaussian_target_heatmaps(cfg, torch.from_numpy(np.array(kps)))
    return {
        **_rig_arrays(scenes, "step_"), "step_size": np.array([scenes[0].width,
                                                               scenes[0].height]),
        "step_dets": dets, "step_mask": mask,
        **_rig_arrays([clip_scene] * CLIP_S, "clip_"),
        "clip_size": np.array([CLIP_W, CLIP_H]),
        "clip": np.random.default_rng(0).integers(
            0, 255, size=(CLIP_S, CLIP_F, CLIP_C, CLIP_H, CLIP_W, 3), dtype=np.uint8),
        "clip_fids": np.arange(CLIP_S * CLIP_F, dtype=np.int32).reshape(CLIP_S, CLIP_F),
        "train_images": images, "train_targets": targets.numpy(),
        "train_weights": weights.numpy(),
    }


def _port_rigs(inputs, prefix):
    w, h = (int(x) for x in inputs[prefix + "size"])
    sets = [make_camera_set(inputs[prefix + "P"][s], inputs[prefix + "K"][s],
                            inputs[prefix + "RT"][s], w, h)
            for s in range(len(inputs[prefix + "P"]))]
    return CameraSet(*(torch.stack(f) for f in zip(*sets)))


def _port_streams(inputs):
    """The 8 streams in one process, unsharded."""
    cfg = TrackerConfig(**STEP_CAPS)
    cams, state = _port_rigs(inputs, "step_"), init_multistream_state(cfg, STEP_STREAMS, "cpu")
    step = make_multistream_step_fn(cfg)
    with torch.inference_mode():
        for t in range(STEP_FRAMES):
            state, _ = step(cams, state, torch.from_numpy(inputs["step_dets"][t]),
                            torch.from_numpy(inputs["step_mask"][t]),
                            torch.full((STEP_STREAMS,), t, dtype=torch.int32))
    return state.track_id.numpy(), state.hist_pose.numpy(), int(state.active.sum())


def _jax_streams(inputs):
    """JAX's sharded multistream step at (2, 2) on the same streams."""
    mesh = jp.make_mesh(data=DATA, model=MODEL, devices=jax.devices()[:WORLD])
    w, h = (int(x) for x in inputs["step_size"])
    rigs = [j_make_cams(inputs["step_P"][s], inputs["step_K"][s], inputs["step_RT"][s], w, h)
            for s in range(STEP_STREAMS)]
    cams = jp.shard_streams(mesh, jax.tree.map(lambda *xs: jnp.stack(xs), *rigs))
    cfg = JConfig(**STEP_CAPS)
    state = jp.shard_streams(mesh, jp.init_multistream_state(cfg, STEP_STREAMS))
    step = jp.make_multistream_step_fn(cfg, mesh)
    for t in range(STEP_FRAMES):
        state, _ = step(cams, state, *jp.shard_streams(mesh, (
            jnp.asarray(inputs["step_dets"][t]), jnp.asarray(inputs["step_mask"][t]),
            jnp.full(STEP_STREAMS, t, jnp.int32))))
    return np.asarray(state.track_id), np.asarray(state.hist_pose)


def _port_clip(inputs):
    det_cfg, pose_cfg = ty.tiny_yolo_test_config(), th.tiny_test_config()
    gen = torch.Generator().manual_seed(0)
    det, pose = ty.yolov3_init(det_cfg, gen), th.hrnet_init(pose_cfg, gen)
    tcfg = TrackerConfig(**CLIP_CAPS)
    fn = make_multistream_clip_fn(det_cfg, pose_cfg, tcfg)
    return recorded_clip(fn, det.eval(), pose.eval(), _port_rigs(inputs, "clip_"),
                         init_multistream_state(tcfg, CLIP_S, "cpu"),
                         torch.from_numpy(inputs["clip"]), torch.from_numpy(inputs["clip_fids"]))


def _train_refs(inputs):
    """The single-process loss and one `make_train_step`, and JAX's sharded
    loss at (2, 2), on the whole batch from the same weights."""
    cfg = th.tiny_test_config()
    batch = tuple(torch.from_numpy(inputs[k]) for k in
                  ("train_images", "train_targets", "train_weights"))
    model = th.hrnet_init(cfg, torch.Generator().manual_seed(2))
    params = _jax_tree(model)
    with torch.no_grad():
        loss = float(tt.heatmap_loss(model, *batch, torch.float32, train_bn=True))
    opt = tt.make_optimizer(tt.trained_tensors(model), lr=LR)
    tt.make_train_step(model, opt, torch.float32, train_bn=True)(*batch)
    after = {name: t.detach().numpy() for name, t in tt.named_trained_tensors(model)}

    mesh = jp.make_mesh(data=DATA, model=MODEL, devices=jax.devices()[:WORLD])
    optimizer = jt.make_optimizer(lr=LR)
    step, shardings_for = jt.make_sharded_train_step(
        jh.tiny_test_config(), optimizer, mesh, compute_dtype=jnp.float32, train_bn=True)
    sharded = jax.device_put(params, shardings_for(params))
    nhwc = lambda x: jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    _, _, jax_loss = step(sharded, optimizer.init(sharded), nhwc(inputs["train_images"]),
                          nhwc(inputs["train_targets"]), jnp.asarray(inputs["train_weights"]))
    n_split_jax = sum(1 for s in jax.tree.leaves(shardings_for(params),
                                                 is_leaf=lambda x: hasattr(x, "spec"))
                      if any(a is not None for a in s.spec))
    return {"loss": loss, "after": after, "jax_loss": float(jax_loss),
            "n_split_jax": n_split_jax}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Launch the four ranks, compute the references meanwhile, collect
    every rank's results."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(tmp / "rendezvous"),
         str(tmp / "inputs.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    try:
        refs = {"streams": _port_streams(inputs), "jax_streams": _jax_streams(inputs),
                "clip": _port_clip(inputs), "train": _train_refs(inputs)}
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return {"inputs": inputs, "ranks": ranks, **refs}


def _by_data_index(ranks, key):
    """The stream-sharded result `key` reassembled over 'data' (from the
    'model' index 0 ranks), after checking that ranks which share a data
    index agree."""
    parts = {}
    for r in ranks:
        d = int(r["data_index"])
        if d in parts:
            np.testing.assert_array_equal(parts[d], r[key])
        parts[d] = r[key]
    return np.concatenate([parts[d] for d in sorted(parts)])


def _fake_mesh(data_index=1, model_index=0):
    return Mesh(None, {"data": DATA, "model": MODEL}, None, None, data_index, model_index,
                torch.device("cpu"))


def test_initialize_is_a_no_op_for_one_process():
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert multihost.process_stream_slice(6) == (0, 6)
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(num_processes=2)


def test_make_mesh_needs_a_group_and_the_card():
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        multihost.global_mesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(data=2, model=2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.initialize("localhost:1", 2, 0)


def test_specs_and_shard_batch_follow_the_data_index():
    mesh = _fake_mesh(data_index=1)
    assert data_sharding(mesh, 3) == ("data", None, None)
    assert data_sharding(mesh, 2, axis=1) == (None, "data")
    assert replicated(mesh) == ()
    x = torch.arange(12).reshape(6, 2)
    cams = CameraSet(*(torch.arange(4 * k).reshape(4, k) for k in range(1, 8)))
    got_x, got_cams = shard_batch(mesh, (x, cams))
    assert torch.equal(got_x, x[3:]) and got_x.data_ptr() != x.data_ptr()
    assert isinstance(got_cams, CameraSet) and torch.equal(got_cams.K, cams.K[2:])
    assert torch.equal(shard_streams(mesh, {"a": np.arange(4)})["a"], torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, torch.zeros(5))


def test_conv_param_sharding_splits_what_jax_splits(run):
    model = th.hrnet_init(th.tiny_test_config(), torch.Generator().manual_seed(2))
    specs = conv_param_sharding(_fake_mesh(), model)
    split = {n: s for n, s in specs.items() if s}
    assert len(split) > 10 and len(split) == run["train"]["n_split_jax"]
    named = dict(tt.named_trained_tensors(model))
    for name, spec in specs.items():
        t = named[name]
        if spec:
            assert spec == ("model",) + (None,) * (t.dim() - 1)
            assert t.shape[0] % MODEL == 0 and t.shape[0] >= 16
        else:
            assert t.dim() not in (1, 4) or t.shape[0] < 16 or t.shape[0] % MODEL
    assert all(int(r["n_split"]) == len(split) for r in run["ranks"])


def test_ranks_form_the_2x2_mesh(run):
    for r, res in enumerate(run["ranks"]):
        assert (int(res["data_index"]), int(res["model_index"])) == divmod(r, MODEL)
        assert res["global_mesh_index"].tolist() == [r // MODEL, r % MODEL]


def test_sharded_streams_equal_the_single_process_run(run):
    track_id, hist_pose, _ = run["streams"]
    np.testing.assert_array_equal(_by_data_index(run["ranks"], "step_track_id"), track_id)
    np.testing.assert_allclose(_by_data_index(run["ranks"], "step_hist_pose"), hist_pose,
                               rtol=0, atol=1e-5)
    assert (track_id >= 0).sum() >= 2 * STEP_STREAMS  # every stream tracks


def test_sharded_streams_equal_jax_sharded_step(run):
    track_id, hist_pose = run["jax_streams"]
    np.testing.assert_array_equal(_by_data_index(run["ranks"], "step_track_id"), track_id)
    np.testing.assert_allclose(_by_data_index(run["ranks"], "step_hist_pose"), hist_pose,
                               rtol=0, atol=1e-5)


def test_mesh_step_refuses_the_whole_stream_axis(run):
    for res in run["ranks"]:
        msg = str(res["step_refused"])
        assert "dets has leading size (8,)" in msg and "4 of 8 streams" in msg, msg


def test_process_stream_slice_follows_the_data_index(run):
    for r, res in enumerate(run["ranks"]):
        d = r // MODEL
        assert (int(res["step_start"]), int(res["step_end"])) == (4 * d, 4 * d + 4)
        assert res["slice_no_mesh"].tolist() == [2 * r, 2 * r + 2]
        assert bool(res["slice_refused"])


def test_all_hosts_metric_agrees_and_sums_all_streams(run):
    metrics = {int(res["metric"]) for res in run["ranks"]}
    own = {int(res["data_index"]): int(res["own_active"]) for res in run["ranks"]}
    assert metrics == {sum(own.values())} == {run["streams"][2]}
    assert run["streams"][2] > 0


def test_sharded_clip_equals_the_unsharded_clip(run):
    states, outs, dets, mask = run["clip"]
    for key, ref in (("clip_track_id", outs.track_id), ("clip_valid", outs.valid),
                     ("clip_pose3d", outs.pose3d), ("clip_hist_pose", states.hist_pose),
                     ("clip_dets", dets), ("clip_mask", mask)):
        np.testing.assert_array_equal(_by_data_index(run["ranks"], key), ref.numpy(), key)
    assert mask.any() and mask.shape == (CLIP_S, CLIP_F, CLIP_C, CLIP_CAPS["max_dets"])


def test_sharded_train_loss_equals_single_process_and_jax(run):
    ref = run["train"]
    for res in run["ranks"]:
        loss = float(res["train_loss1"])
        assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"]), (loss, ref["loss"])
        assert abs(loss - ref["jax_loss"]) <= 1e-5 * abs(ref["jax_loss"]), (loss, ref["jax_loss"])


def test_sharded_train_params_after_one_step_equal_unsharded(run):
    after = run["train"]["after"]
    for res in run["ranks"]:
        got = {k[len("param/"):]: v for k, v in res.items() if k.startswith("param/")}
        assert got.keys() == after.keys()
        for name, ref in after.items():
            np.testing.assert_allclose(got[name], ref, rtol=1e-5, atol=1e-2 * LR, err_msg=name)


def test_split_leaves_and_adam_moments_hold_half_the_rows(run):
    for res in run["ranks"]:
        rows = res["split_rows"]  # local, exp_avg, exp_avg_sq, gathered
        assert len(rows) == int(res["n_split"])
        assert (rows[:, :3] * MODEL == rows[:, 3:]).all()


def test_second_step_runs_and_unequal_batches_raise(run):
    for res in run["ranks"]:
        assert np.isfinite(float(res["train_loss2"]))
        assert float(res["train_loss2"]) != float(res["train_loss1"])
        assert "local batches differ" in str(res["unequal_refused"])


def _n_bn():
    model = th.hrnet_init(th.tiny_test_config(), torch.Generator().manual_seed(2))
    return sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_collectives_per_step_are_counted(run):
    n_bn = _n_bn()
    for res in run["ranks"]:
        # by kind (all-reduces, all-gathers, reduce-scatters): the gradients'
        # all-reduce; the parameters' all-gather and one a BN forward; one
        # reduce-scatter a BN backward; a new key's first call adds the
        # batch-size all-gather
        assert res["train_collectives1"].tolist() == [1, 2 + n_bn, n_bn]
        assert res["train_collectives2"].tolist() == [1, 1 + n_bn, n_bn]
        # two full steps and a gather(); the refused third stops at its
        # batch-size all-gather
        assert res["train_counted"].tolist() == [2, 5 + 2 * n_bn, 2 * n_bn]


def test_captured_sharded_step_equals_eager_bit_for_bit(run):
    for res in run["ranks"]:
        assert res["captured_unequal"].size == 0, res["captured_unequal"][:8]
        # every local tensor, its gradient, AdamW's two moments and step count
        assert int(res["captured_tensors"]) == 5 * int(res["trained_tensors"]) > 500
        assert res["key_replays"][0].tolist() == [BATCH // DATA, 2, 5]


def test_sharded_step_buffers_are_flat_and_fixed(run):
    for res in run["ranks"]:
        n = int(res["trained_tensors"])
        assert int(res["flat_param_storages"]) == int(res["flat_grad_storages"]) == 1
        assert int(res["flat_param_offsets"]) == int(res["flat_grad_offsets"]) == n
        assert bool(res["captured_grads_held"])


def test_captured_sharded_step_issues_the_same_ops_every_step(run):
    n_bn = _n_bn()
    for res in run["ranks"]:
        assert bool(res["captured_same_ops"]) and int(res["captured_ops"]) > 1000
        assert int(res["captured_host_reads"]) == 0
        # the parameters' and the BNs' all-gathers, the BNs' reduce-scatters,
        # the gradients' all-reduce, each one c10d op
        assert sorted(res["captured_c10d"].tolist()) == [1, n_bn, 1 + n_bn], (
            res["captured_c10d_names"])


def test_one_rank_sharded_step_equals_the_unsharded_step_bit_for_bit(run):
    for res in run["ranks"]:
        assert res["one_rank_unequal"].size == 0, res["one_rank_unequal"][:8]
        assert int(res["one_rank_tensors"]) == int(res["trained_tensors"]) > 100


def test_new_batch_shape_is_a_new_key_with_one_batch_size_all_gather(run):
    n_bn = _n_bn()
    for res in run["ranks"]:
        # half the batch twice (a new key: its first call all-gathers the
        # batch sizes), then the first shape again
        assert res["key_collectives"].tolist() == [[1, 2 + n_bn, n_bn], [1, 1 + n_bn, n_bn],
                                                   [1, 1 + n_bn, n_bn]]
        assert res["key_replays"].tolist() == [[BATCH // DATA, 2, 5], [BATCH // DATA // 2, 2, 0]]
