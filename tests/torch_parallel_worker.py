"""One rank of the port's four-process gloo tests (tests/test_torch_parallel.py).

Not a test module: launched as
`python tests/torch_parallel_worker.py <rank> <world> <rendezvous file> <inputs.npz> <out dir>`.
It imports the port only (no JAX, nothing of the JAX package), forms the
group over a `file://` rendezvous, and on a (data=2, model=2) mesh runs
every case of the test file on its own shard, then writes its results to
`<out dir>/rank<rank>.npz`.
"""
import copy
import sys
from functools import partial

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

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
#: Steps of the captured path against `step.eager`: 2 warm-ups, the capture, replays.
CAPTURED_STEPS = 6


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


def train_batch(mesh, inputs):
    return shard_batch(mesh, tuple(torch.from_numpy(inputs[k]) for k in (
        "train_images", "train_targets", "train_weights")))


def collectives(step):
    """The last call's collectives by kind, in `mesh_mod.COUNTERS` order."""
    return [step.collectives[k] for k in mesh_mod.COUNTERS]


def train_case(mesh, inputs, out):
    """Two steps of `make_sharded_train_step` on the tiny HRNet, train-mode
    BN synchronized over 'data', parameters split over 'model'."""
    cfg = tiny_test_config()
    model = hrnet_init(cfg, torch.Generator().manual_seed(2))
    step, shardings_for = tt.make_sharded_train_step(
        model, partial(tt.make_optimizer, lr=1e-4), mesh, torch.float32, train_bn=True)
    batch = train_batch(mesh, inputs)
    loss1 = step(*batch)
    out["train_collectives1"] = collectives(step)
    gathered = step.gather()
    out["train_loss1"] = float(loss1)
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
    out["train_collectives2"] = collectives(step)
    try:  # unequal local batches: every rank must refuse
        cut = 1 if mesh.data_index == 0 else 2
        step(*(x[:cut] for x in batch))
        out["unequal_refused"] = ""
    except ValueError as e:
        out["unequal_refused"] = str(e)


def _arg(x):
    """An op argument as recorded: a tensor's shape, dtype and device; a
    c10d object (boxed afresh at each call) by its class, a process group
    by its name too."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.device.type
    if isinstance(x, torch.ScriptObject):
        kind = x._type().qualified_name().rsplit(".", 1)[-1]
        if kind == "ProcessGroup":
            return f"{kind} {torch.distributed.ProcessGroup.unbox(x).group_name}"
        return kind
    return repr(x)


class OpRecorder(TorchDispatchMode):
    """Every op reaching the dispatcher, with its non-tensor arguments and
    its tensors' shapes, dtypes and devices (tests/test_torch_graphed_train.py's)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not str(func).startswith("profiler."):  # record_function marks: no work
            leaves, spec = tree_flatten((args, kwargs))
            self.ops.append((str(func), str(spec), tuple(_arg(x) for x in leaves)))
        return func(*args, **kwargs)


def everything(step):
    """{name: tensor} of every local trained tensor, its `.grad` and its
    optimizer state."""
    out = {}
    for name, t in step.tensors.items():
        out[name] = t.detach().clone()
        out[name + ".grad"] = t.grad.clone()
        for k, v in step.optimizer.state[t].items():
            out[f"{name}.{k}"] = v.clone()
    return out


def captured_case(mesh, inputs, out):
    """`make_sharded_train_step`'s captured path (on the CPU its body at
    every call) against `step.eager` from the same weights, with capturable
    foreach AdamW as the card runs it (its device check patched to take the
    CPU): CAPTURED_STEPS batches, then a batch of a new local size, then the
    first size again. The calls after the warm-ups are recorded op by op."""
    from torch.optim import adam

    from tpupose_torch.runtime.graphs import WARMUP

    adam._get_capturable_supported_devices = lambda *_, **__: ["cpu"]
    adam._default_to_fused_or_foreach = lambda *_, **__: (False, True)
    model = hrnet_init(tiny_test_config(), torch.Generator().manual_seed(5))

    def make():
        return tt.make_sharded_train_step(
            model, lambda ts: torch.optim.AdamW(ts, lr=1e-3, weight_decay=1e-4, capturable=True),
            mesh, torch.float32, train_bn=True)[0]

    graphed, eager = make(), make()
    images, targets, weights = train_batch(mesh, inputs)
    batches = [(images * (1 - 0.05 * k), targets, weights) for k in range(CAPTURED_STEPS)]
    held = {name: t.grad for name, t in graphed.tensors.items()}
    unequal, ops, reads = [], [], 0
    for k, b in enumerate(batches):
        if k < WARMUP:
            loss = graphed(*b)
        else:
            with OpRecorder() as rec:
                loss = graphed(*b)
            ops.append(rec.ops)
            reads += sum("_local_scalar_dense" in op or "aten.item" in op for op, *_ in rec.ops)
        ref = eager.eager(*b)
        got, want = everything(graphed), everything(eager)
        unequal += [f"{k}:loss"] * (not torch.equal(loss, ref))
        unequal += [f"{k}:{n}" for n, v in want.items() if not torch.equal(got[n], v)]
    c10d = [op for op, *_ in ops[0] if op.startswith("c10d.")]
    out.update(
        captured_unequal=unequal, captured_tensors=len(want), captured_ops=len(ops[0]),
        captured_same_ops=all(o == ops[0] for o in ops[1:]), captured_host_reads=reads,
        captured_c10d=[c10d.count(n) for n in sorted(set(c10d))],
        captured_c10d_names=sorted(set(c10d)),
        captured_grads_held=all(t.grad is held[n] for n, t in graphed.tensors.items()),
        captured_replays=[k["replays"] for k in graphed.stats()],
        # one flat buffer each: one storage, the tensors in it at distinct offsets
        flat_param_storages=len({t.untyped_storage().data_ptr() for t in graphed.tensors.values()}),
        flat_grad_storages=len({t.grad.untyped_storage().data_ptr()
                                for t in graphed.tensors.values()}),
        flat_param_offsets=len({t.storage_offset() for t in graphed.tensors.values()}),
        flat_grad_offsets=len({t.grad.storage_offset() for t in graphed.tensors.values()}),
        trained_tensors=len(graphed.tensors))
    half = tuple(x[:x.shape[0] // 2] for x in batches[0])
    for b in (half, half, batches[0]):
        graphed(*b)
        out.setdefault("key_collectives", []).append(collectives(graphed))
    out["key_replays"] = [[k["shapes"][0][0], k["warmups"], k["replays"]]
                          for k in graphed.stats()]


def one_rank_case(inputs, out):
    """The sharded step over a one-rank group of this rank alone, a (1, 1)
    mesh, against `make_train_step` from the same weights: CAPTURED_STEPS
    steps on the whole batch, losses, every trained tensor and its
    gradient."""
    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    alone = [torch.distributed.new_group([r]) for r in range(world)][rank]
    mesh = mesh_mod.Mesh(None, {"data": 1, "model": 1}, alone, alone, 0, 0, torch.device("cpu"))
    model = hrnet_init(tiny_test_config(), torch.Generator().manual_seed(7))
    ref = copy.deepcopy(model)
    step = tt.make_sharded_train_step(model, partial(tt.make_optimizer, lr=1e-3), mesh,
                                      torch.float32, train_bn=True)[0]
    ref_step = tt.make_train_step(ref, tt.make_optimizer(tt.trained_tensors(ref), lr=1e-3),
                                  torch.float32, train_bn=True)
    images, targets, weights = (torch.from_numpy(inputs[k]) for k in (
        "train_images", "train_targets", "train_weights"))
    unequal = []
    for k in range(CAPTURED_STEPS):
        b = (images * (1 - 0.05 * k), targets, weights)
        unequal += [f"{k}:loss"] * (not torch.equal(step(*b), ref_step(*b)))
        whole = step.gather()
        for name, t in tt.named_trained_tensors(ref):
            unequal += [f"{k}:{name}"] * (not torch.equal(whole[name], t.detach()))
            unequal += [f"{k}:{name}.grad"] * (not torch.equal(step.tensors[name].grad, t.grad))
    out.update(one_rank_unequal=unequal, one_rank_tensors=len(whole))


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
    before = [getattr(mesh_mod, k) for k in mesh_mod.COUNTERS]
    train_case(mesh, inputs, out)
    out["train_counted"] = [getattr(mesh_mod, k) - b for k, b in zip(mesh_mod.COUNTERS, before)]
    captured_case(mesh, inputs, out)
    one_rank_case(inputs, out)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
