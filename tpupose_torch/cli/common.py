"""Shared CLI plumbing for testmodel / evalmodel.

Counterpart of `tpupose/cli/common.py`. Builds a Pipeline from a
reference-format YAML config (same `--dataset` selection as
`src/testmodel.py:101-107` / `src/evalmodel.py:379-386`) and runs the
per-frame loop. Three backend modes:
  * real:      the published checkpoints (.weights / .pth paths in the YAML),
               or a serving bundle that `cli.convert` made from them
  * replay:    2D detections loaded from a pickle (re-scoring w/o models)
  * synthetic: the built-in synthetic scene (no dataset or weights needed)
"""
from __future__ import annotations

import collections
import os
import pickle
import time as _time

import numpy as np
import torch

from tpupose_torch.data.config import Config, tracker_config_from
from tpupose_torch.data.dataset import load_filenames, load_images
from tpupose_torch.pipeline import registry_defs  # noqa: F401  (fills the registries)
from tpupose_torch.pipeline.facade import Pipeline, needs_hrnet
from tpupose_torch.tracking.tracker import FrameOutput
from tpupose_torch.utils.registry import POSE_MODELS
from tpupose_torch.utils.timing import StageTimer


def build_pipeline_real(cfg: Config, camera_parameter, width, height,
                        bundle: str | None = None, device=None,
                        int8: bool = False) -> Pipeline:
    """A Pipeline serving the config's models, `device` as `Pipeline`'s.

    Without `bundle`: the config's checkpoints, the darknet `.weights`
    detector and the pose net's checkpoint (a `pose_hrnet` `.pth`, or an
    mmpose ViTPose one for POSE_MODEL "ViTPose"), BN folded into bf16
    weights (`cli.convert.load_checkpoints`). With `bundle`: the modules a
    `python -m tpupose_torch.cli.convert` run wrote (bf16, or already
    int8), after `load_bundle` has checked its manifest against the
    config; no checkpoint is read and nothing is folded. A ViTPose pose
    net has no bundle and no int8 path yet: `bundle` or `int8` (the
    caller's `--int8`) raise for it, before a checkpoint is read."""
    from tpupose_torch.cli.convert import load_bundle, load_checkpoints

    det_cfg = yolo_config_from(cfg)
    pose_cfg = pose_config_from(cfg)
    if bundle:
        needs_hrnet(pose_cfg, "--bundle")
    if int8:
        needs_hrnet(pose_cfg, "--int8")
    cams = Pipeline.camera_set_from_parameter_dict(
        camera_parameter, width, height, num_cameras=len(cfg.dataset.folders_order)
    )
    tcfg = tracker_config_from(cfg, num_cameras=cams.num_cameras)
    if bundle:
        detector, pose_model = load_bundle(bundle, det_cfg, pose_cfg)
    else:
        detector, pose_model, _ = load_checkpoints(cfg, det_cfg)
    return Pipeline(cams, tcfg, det_cfg, detector, pose_cfg, pose_model, device=device)


def skip_int8_calibration(args) -> bool:
    """True, with a note, for `--int8` on an int8 `--bundle`: its models
    were calibrated at convert time, and there are no float convs left to
    calibrate."""
    from tpupose_torch.cli.convert import read_manifest

    if not (args.bundle and read_manifest(args.bundle).get("quantized")):
        return False
    print("note: bundle is already int8-quantized (calibrated at convert time); "
          "skipping in-process calibration")
    return True


def yolo_config_from(cfg: Config):
    from tpupose_torch.models.yolov3 import YoloConfig

    d = cfg.detect_model
    return YoloConfig(
        score_thresh=d.score_thresh,
        nms_thresh=d.nms_thresh,
        width_mult=d.width_mult,
        num_classes=d.num_classes,
        input_size=d.input_size,
        max_candidates=d.max_candidates,
    )


def hrnet_config_from(cfg: Config):
    """The `HRNetConfig` of the config's pose model section."""
    return POSE_MODELS.get("hrpose")(cfg.pose_model, load=False)[0]


def pose_config_from(cfg: Config):
    """The pose net's configuration, by the YAML's POSE_MODEL through the
    `POSE_MODELS` registry ("HRPose" or "ViTPose")."""
    return POSE_MODELS.get(cfg.pipeline.pose_model)(cfg.pose_model, load=False)[0]


def device_prefetch(frame_source, device, depth: int = 2):
    """Overlap host->device copies with device compute.

    Each item's host arrays are copied into pinned host memory (on a CUDA
    device) and sent with `non_blocking=True`, `depth` items ahead of the
    consumer, so the next frame's copy runs behind the current frame's
    work. Frames already on the card (the loader decoded them there) have
    no copy to overlap: they pass through at once, neither copied, pinned
    nor held back, so the loader's own decode-ahead is not doubled. Works
    for both image frames and replay detections."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def move(item):
        frame_id, timestamp, images, dets, mask = item
        if images is not None:
            images = put(images)
        if dets is not None:
            dets, mask = put(dets), put(mask)
        return frame_id, timestamp, images, dets, mask

    queue = collections.deque()
    for item in frame_source:
        images = item[2]
        if torch.is_tensor(images) and images.is_cuda:
            while queue:  # keep the order
                yield queue.popleft()
            yield item[:2] + (images.to(device, non_blocking=True),) + item[3:]
            continue
        queue.append(move(item))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def _leading(out: FrameOutput) -> FrameOutput:
    """A per-frame FrameOutput with a leading frame axis of 1."""
    return FrameOutput(*(x[None] for x in out))


def run_eval_loop(cfg: Config, pipe: Pipeline, frame_source, timer: StageTimer,
                  clip: int = 0):
    """Per-frame loop accumulating 3D predictions and 2D annotations.

    frame_source yields (frame_id, timestamp, images|None, dets|None,
    mask|None).

    clip > 1 buffers that many image frames and runs them through the
    two-stage clip pipeline (`Pipeline.process_clip`: batched NN, then the
    tracker over the clip), falling back to per-frame processing
    (`process_frame`) for a trailing partial clip and for replay items.
    The tracker state evolves the same way on both paths.

    FrameOutputs stay on the device during the loop and move to the host in
    one batch at the end, then `harvest` turns them into artifacts: nothing
    in the loop needs them on the host.

    Clip mode times `process_clip` as the JAX package's loop does, on the
    host clock with no device sync of its own. Here stage A waits on the
    card a few times a batch (its detection post-processing) and the
    tracker, which reads nothing on the host, is bound by the host's own
    launches, so the card is done moments after `process_clip` returns: the
    "track" seconds are the clip's whole time, stage A included, where the
    JAX package's are mostly dispatch.
    """
    # prefetch at least a clip ahead so the NN stage never starves
    frame_source = device_prefetch(frame_source, pipe.device, depth=max(2, clip))
    chunks = []  # FrameOutputs with a leading frame axis
    keys = []
    frame_ids = []
    timestamps = []
    is_panoptic = cfg.dataset.test_dataset == "Panoptic"
    buf = []  # (frame_id, images) buffered for clip mode

    def flush_clip():
        if not buf:
            return
        if len(buf) == clip:
            fids = np.asarray([b[0] for b in buf], np.int32)
            imgs = torch.stack([b[1] for b in buf])
            start = _time.perf_counter()
            outs, _, _ = pipe.process_clip(fids, imgs)
            timer.add("track", _time.perf_counter() - start, count=len(buf))
            chunks.append(outs)
        else:  # trailing partial clip: per-frame (state evolution identical)
            for fid, images in buf:
                with timer.time("track"):
                    out, _, _ = pipe.process_frame(fid, images)
                chunks.append(_leading(out))
        buf.clear()

    for frame_id, timestamp, images, dets, mask in frame_source:
        if images is not None and clip > 1:
            buf.append((frame_id, images))
            if len(buf) == clip:
                flush_clip()
        elif images is not None:
            with timer.time("track"):
                out, _, _ = pipe.process_frame(frame_id, images)
            chunks.append(_leading(out))
        else:
            flush_clip()  # keep frame order if sources are mixed
            with timer.time("track"):
                out = pipe.person_track(frame_id, dets, mask)
            chunks.append(_leading(out))
        keys.append(timestamp if is_panoptic else frame_id)
        frame_ids.append(frame_id)
        timestamps.append(timestamp)
    flush_clip()

    multi_poses3d = {}
    annotations = []
    if not chunks:
        return multi_poses3d, annotations
    stacked = FrameOutput(*(torch.cat(field).cpu() for field in zip(*chunks)))
    for i, key in enumerate(keys):
        out_i = FrameOutput(*(x[i] for x in stacked))
        pts3d, ids, anns = pipe.harvest(
            out_i, frame_ids[i], timestamps[i] if is_panoptic else None
        )
        multi_poses3d[key] = pts3d
        annotations.extend(anns)
    return multi_poses3d, annotations


def dataset_frame_source(cfg: Config, use_native: bool = True,
                         timer: StageTimer | None = None, prefetch: int = 4,
                         *, device=None):
    """Frames from disk, as (frame_id, timestamp, images, None, None).

    The JAX package's positional parameters. `device` is resolved as
    `Pipeline`'s: None is CUDA, which must be present. With `use_native`, a
    decode-ahead `runtime.loader.FrameLoader` decodes the frames: on a CUDA
    device with nvJPEG, each frame a (V, H, W, 3) uint8 tensor on the card
    (JPEG files only: other files raise there); on the CPU with Pillow on
    worker threads, numpy frames. `prefetch` frames are decoded ahead (at
    least 4): clip mode pulls a whole clip back to back, so callers pass at
    least the clip length. With `use_native=False`, Pillow decodes one
    frame after another on this thread, on the CPU only: a CUDA device
    raises.

    When `timer` is given, the time this thread spends blocked on the next
    frame is recorded as the `decode_wait` stage (the whole serial decode
    cost without `use_native`, the cost the reference pays inside its timed
    loop, `src/dataset.py:36-45`), and the loader's workers' own decode
    time as `decode_work`, counted per frame decoded."""
    from tpupose_torch.data.dataset import parse_timestamp
    from tpupose_torch.pipeline.facade import resolve_device
    from tpupose_torch.runtime.loader import FrameLoader

    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card and not use_native:
        raise ValueError("dataset_frame_source: the sequential loop (use_native=False) "
                         "decodes with Pillow on the host; pass device='cpu', or "
                         "use_native=True to decode on the card")
    datas = load_filenames(cfg.dataset)
    start, end = cfg.dataset.test_range
    frame_paths = datas[start:end]
    if not frame_paths:
        return
    if on_card and not frame_paths[0][0].lower().endswith((".jpg", ".jpeg")):
        raise ValueError(f"dataset_frame_source: nvJPEG decodes JPEG files only, not "
                         f"{frame_paths[0][0]}; pass device='cpu' to decode them with Pillow")

    if not use_native:
        for frame_id, paths in zip(range(start, end), frame_paths):
            t0 = _time.perf_counter()
            images, timestamp = load_images(cfg.dataset.test_dataset, paths)
            images = np.stack(images)
            if timer is not None:
                timer.add("decode_wait", _time.perf_counter() - t0)
            yield frame_id, timestamp, images, None, None
        return

    loader = FrameLoader(frame_paths, prefetch=max(4, prefetch), threads=2, device=device)
    try:
        for n, (frame_id, paths) in enumerate(zip(range(start, end), frame_paths)):
            t0 = _time.perf_counter()
            images = next(loader, None)
            if images is None:
                raise RuntimeError(f"the frame loader ended after {n} of "
                                   f"{len(frame_paths)} frames")
            if timer is not None:
                timer.add("decode_wait", _time.perf_counter() - t0)
            yield (frame_id, parse_timestamp(cfg.dataset.test_dataset, paths[0]),
                   images, None, None)
    finally:
        loader.close()
        stats = loader.stats()
        if timer is not None and stats["frames_decoded"]:
            timer.add("decode_work", stats["decode_s"],
                      count=int(stats["frames_decoded"]))


def synthetic_frame_source(num_frames=60, num_cameras=5, num_actors=3,
                           max_dets=16, noise_px=1.0, drop_prob=0.1, seed=0):
    """Frames from the built-in synthetic scene, replay-mode (no NN)."""
    from tpupose_torch.data.synthetic import make_scene

    scene = make_scene(
        num_frames=num_frames, num_cameras=num_cameras, num_actors=num_actors,
        noise_px=noise_px, drop_prob=drop_prob, seed=seed,
    )

    def gen():
        for t in range(scene.num_frames):
            dets = np.zeros((num_cameras, max_dets, 17, 3), np.float32)
            mask = np.zeros((num_cameras, max_dets), bool)
            for c, d in enumerate(scene.detections_list(t)):
                dets[c, : len(d)] = d
                mask[c, : len(d)] = True
            yield t, t, None, dets, mask

    return scene, gen()


def synthetic_tracks(num_frames, timer: StageTimer, device):
    """The synthetic scene's detections through the tracker as one clip
    (`track_clip`): one copy in, one copy of the outputs out, timed as the
    "track" stage per frame. Returns (scene, a replay Pipeline, the
    FrameOutput stacked over frames on the host)."""
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.tracking.tracker import TrackerConfig, init_state, track_clip

    scene, source = synthetic_frame_source(num_frames=num_frames)
    rig = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    tcfg = TrackerConfig(num_cameras=scene.num_cameras)
    pipe = Pipeline(rig, tcfg, device=device)
    all_dets, all_masks = [], []
    for _, _, _, dets, mask in source:
        all_dets.append(dets)
        all_masks.append(mask)
    F = len(all_dets)
    dets = torch.as_tensor(np.stack(all_dets), device=pipe.device)
    masks = torch.as_tensor(np.stack(all_masks), device=pipe.device)
    fids = torch.arange(F, dtype=torch.int32, device=pipe.device)
    with timer.time("track"), torch.inference_mode():
        _, outs = track_clip(tcfg, pipe.cams, init_state(tcfg, pipe.device),
                             dets, masks, fids)
        outs = FrameOutput(*(x.cpu() for x in outs))
    timer.counts["track"] = F  # report per-frame
    return scene, pipe, outs


def result_path(cfg: Config):
    store_dir = os.path.join(cfg.output, cfg.dataset.test_dataset, "logs")
    name = "{}_{}_{}_{}.pkl".format(
        cfg.pipeline.detect_model,
        cfg.pipeline.pose_model,
        cfg.pipeline.person_matcher,
        cfg.dataset.root.rstrip("/").split("/")[-1],
    )
    return os.path.join(store_dir, name)


def load_camera_parameter(cfg: Config):
    path = os.path.join(cfg.dataset.root, cfg.dataset.calibration_file)
    with open(path, "rb") as f:
        return pickle.load(f)
