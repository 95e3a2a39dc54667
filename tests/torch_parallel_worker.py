"""One rank of the port's four-process gloo tests (tests/test_torch_parallel.py).

Not a test module: launched as
`python tests/torch_parallel_worker.py <rank> <world> <rendezvous file> <inputs.npz> <out dir>`.
It imports the port only (no JAX, nothing of the JAX package), forms the
group over a `file://` rendezvous, and on a (data=2, model=2) mesh runs
every case of the test file on its own shard, then writes its results to
`<out dir>/rank<rank>.npz`.
"""
import sys
from functools import partial

import numpy as np
import torch

from tpupose_torch.geometry import CameraSet, make_camera_set
from tpupose_torch.models import train as tt
from tpupose_torch.models.hrnet import hrnet_init, tiny_test_config
from tpupose_torch.models.yolov3 import tiny_yolo_test_config, yolov3_init
from tpupose_torch.parallel import (
    init_multistream_state,
    make_mesh,
    make_multistream_clip_fn,
    make_multistream_step_fn,
    multihost,
    shard_batch,
    shard_streams,
)
from tpupose_torch.parallel import mesh as mesh_mod
from tpupose_torch.tracking.tracker import TrackerConfig

#: The trackers of the two stream cases (tests/test_parallel.py's caps and
#: tests/test_throughput_training.py's).
STEP_CAPS = dict(num_cameras=4, max_tracks=8, max_dets=6, max_hyp=16)
CLIP_CAPS = dict(num_cameras=3, max_dets=8, max_tracks=8, max_hyp=16)


def rigs(inputs, prefix):
    """The streams' CameraSets stacked on a leading stream axis."""
    p, k, rt = inputs[prefix + "P"], inputs[prefix + "K"], inputs[prefix + "RT"]
    w, h = (int(x) for x in inputs[prefix + "size"])
    sets = [make_camera_set(torch.from_numpy(p[s]), torch.from_numpy(k[s]),
                            torch.from_numpy(rt[s]), w, h) for s in range(len(p))]
    return CameraSet(*(torch.stack(f) for f in zip(*sets)))


def stream_case(mesh, inputs, out):
    """8 streams of different scenes at (2, 2): each rank steps its own."""
    cfg = TrackerConfig(**STEP_CAPS)
    dets, mask = inputs["step_dets"], inputs["step_mask"]  # (F, S, ...)
    frames, total = dets.shape[:2]
    start, end = multihost.process_stream_slice(total, mesh)
    cams = shard_streams(mesh, rigs(inputs, "step_"))
    state = shard_streams(mesh, init_multistream_state(cfg, total, device="cpu"))
    step = make_multistream_step_fn(cfg, mesh, num_streams=total)
    with torch.inference_mode():
        for t in range(frames):
            state, _ = step(cams, state, *multihost.global_streams(
                mesh, (dets[t, start:end], mask[t, start:end],
                       np.full(end - start, t, np.int32))))
    out.update(step_track_id=state.track_id.numpy(), step_hist_pose=state.hist_pose.numpy(),
               step_start=start, step_end=end)
    whole = (torch.from_numpy(dets[0]), torch.from_numpy(mask[0]),
             torch.zeros(total, dtype=torch.int32))
    try:
        step(cams, state, *whole)
        out["step_refused"] = ""
    except ValueError as e:
        out["step_refused"] = str(e)
    metric = multihost.all_hosts_metric(mesh, lambda st: st.active.sum())
    out.update(metric=int(metric(state)), own_active=int(state.active.sum()),
               slice_no_mesh=multihost.process_stream_slice(total))
    try:
        multihost.process_stream_slice(total + 1, mesh)
        out["slice_refused"] = False
    except ValueError:
        out["slice_refused"] = True


def recorded_clip(fn, *args):
    """fn(*args) of a multi-stream clip function, and the stage-A
    detections and masks it made, (S, F, ...)."""
    from tpupose_torch.parallel import throughput

    chunks, inner = [], throughput._clip_detections

    def recording(*a):
        chunks.append(inner(*a))
        return chunks[-1]

    throughput._clip_detections = recording
    try:
        with torch.no_grad():
            states, outs = fn(*args)
    finally:
        throughput._clip_detections = inner
    s, f = args[4].shape[:2]
    dets = torch.cat([d.reshape(s, -1, *d.shape[1:]) for d, _ in chunks], dim=1)
    mask = torch.cat([m.reshape(s, -1, *m.shape[1:]) for _, m in chunks], dim=1)
    return states, outs, dets.reshape(s, f, -1, *dets.shape[2:]), mask.reshape(s, f, -1,
                                                                               mask.shape[-1])


def clip_case(mesh, inputs, out):
    """The tiny multi-stream clip over this rank's streams."""
    det_cfg, pose_cfg = tiny_yolo_test_config(), tiny_test_config()
    tcfg = TrackerConfig(**CLIP_CAPS)
    gen = torch.Generator().manual_seed(0)
    detector = yolov3_init(det_cfg, gen)
    pose = hrnet_init(pose_cfg, gen)
    clip = inputs["clip"]
    cams = shard_streams(mesh, rigs(inputs, "clip_"))
    states = shard_streams(mesh, init_multistream_state(tcfg, clip.shape[0], device="cpu"))
    clip_s, fids = shard_streams(mesh, (torch.from_numpy(clip), torch.from_numpy(
        inputs["clip_fids"])))
    fn = make_multistream_clip_fn(det_cfg, pose_cfg, tcfg)
    states, outs, dets, mask = recorded_clip(fn, detector.eval(), pose.eval(), cams, states,
                                             clip_s, fids)
    out.update(clip_track_id=outs.track_id.numpy(), clip_valid=outs.valid.numpy(),
               clip_pose3d=outs.pose3d.numpy(), clip_hist_pose=states.hist_pose.numpy(),
               clip_dets=dets.numpy(), clip_mask=mask.numpy())


def train_case(mesh, inputs, out):
    """Two steps of `make_sharded_train_step` on the tiny HRNet, train-mode
    BN synchronized over 'data', parameters split over 'model'."""
    cfg = tiny_test_config()
    model = hrnet_init(cfg, torch.Generator().manual_seed(2))
    step, shardings_for = tt.make_sharded_train_step(
        model, partial(tt.make_optimizer, lr=1e-4), mesh, torch.float32, train_bn=True)
    batch = shard_batch(mesh, tuple(torch.from_numpy(inputs[k]) for k in (
        "train_images", "train_targets", "train_weights")))
    loss1 = step(*batch)
    gathered = step.gather()
    out["train_loss1"] = float(loss1)
    out["train_collectives"] = [step.collectives[k] for k in sorted(step.collectives)]
    for name, t in gathered.items():
        out["param/" + name] = t.numpy()
    rows = []
    for name in step.split:
        t = step.tensors[name]
        st = step.optimizer.state[t]
        rows.append((t.shape[0], st["exp_avg"].shape[0], st["exp_avg_sq"].shape[0],
                     gathered[name].shape[0]))
    out["split_rows"] = np.array(rows)
    out["n_split"] = sum(1 for s in shardings_for(model).values() if s)
    out["train_loss2"] = float(step(*batch))
    try:  # unequal local batches: every rank must refuse
        cut = 1 if mesh.data_index == 0 else 2
        step(*(x[:cut] for x in batch))
        out["unequal_refused"] = ""
    except ValueError as e:
        out["unequal_refused"] = str(e)


def main():
    rank, world, rendezvous, inputs_path, out_dir = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.initialize("file://" + rendezvous, world, rank, device="cpu")
    inputs = dict(np.load(inputs_path))
    mesh = make_mesh(data=2, model=2, device="cpu")
    g = multihost.global_mesh(model=2)
    out = {"rank": rank, "data_index": mesh.data_index, "model_index": mesh.model_index,
           "global_mesh_index": [g.data_index, g.model_index]}
    stream_case(mesh, inputs, out)
    clip_case(mesh, inputs, out)
    before = mesh_mod.all_reduces
    train_case(mesh, inputs, out)
    out["all_reduces"] = mesh_mod.all_reduces - before
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
