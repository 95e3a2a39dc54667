"""Demo/timing entry point (reference `src/testmodel.py` equivalent).

    python -m tpupose_torch.cli.testmodel --dataset CampusSeq1
    python -m tpupose_torch.cli.testmodel --synthetic

Counterpart of `tpupose/cli/testmodel.py`: runs the frame loop, optionally
writes 2D-skeleton overlay images, and prints the reference-format timing
report (detect s/f, pose s/f, track s/f, fps, tracking fps —
`src/testmodel.py:92-99`). Runs on CUDA unless `--device` names another
device.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpupose_torch.cli.common import (
    build_pipeline_real,
    dataset_frame_source,
    load_camera_parameter,
    skip_int8_calibration,
    synthetic_tracks,
)
from tpupose_torch.data.config import load_config
from tpupose_torch.pipeline.facade import resolve_device
from tpupose_torch.tracking.tracker import FrameOutput
from tpupose_torch.utils.timing import StageTimer
from tpupose_torch.utils.viz import draw_skeleton_overlay


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="CampusSeq1")
    parser.add_argument("--config-dir", type=str, default="configs")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--save-images", action="store_true")
    parser.add_argument("--clip", type=int, default=32,
                        help="buffer N frames through the two-stage clip "
                             "pipeline (as evalmodel); 0 = per-frame")
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving mode (calibrated on the first "
                             "frame's views, then a decoded-keypoint "
                             "self-check vs bf16 — see evalmodel "
                             "--int8-on-drift)")
    parser.add_argument("--int8-on-drift", type=str, default="escalate",
                        choices=["escalate", "raise", "warn"],
                        help="what to do when the int8 self-check fails "
                             "(escalate = distill-QAT, then re-check; see "
                             "evalmodel --int8-on-drift)")
    parser.add_argument("--bundle", type=str, default=None,
                        help="pre-converted serving bundle dir (python -m "
                             "tpupose_torch.cli.convert)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda, which "
                             "must be present; cpu for a host without a card)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    timer = StageTimer()
    if args.synthetic:
        scene, _, outs = synthetic_tracks(args.frames, timer, device)
        print(f"confirmed track-frames: {int(outs.valid.sum())}")
        print(timer.report(num_views=scene.num_cameras))
        return

    cfg = load_config(
        os.path.join(args.config_dir, args.dataset, "model_configs.yaml")
    )
    camera_parameter = load_camera_parameter(cfg)
    source = dataset_frame_source(cfg, True, timer, prefetch=max(4, args.clip),
                                  device=device)
    first = next(source)
    images0 = first[2]
    pipe = build_pipeline_real(cfg, camera_parameter, images0.shape[2],
                               images0.shape[1], bundle=args.bundle, device=device)
    if args.int8 and not skip_int8_calibration(args):
        pipe.quantize_models(images0, on_drift=args.int8_on_drift)
    out_dir = os.path.join(cfg.output, cfg.dataset.test_dataset, "Images")
    os.makedirs(out_dir, exist_ok=True)

    def frames():
        yield first
        yield from source

    def save_overlays(out, frame_id, timestamp, images):
        _, ids, anns = pipe.harvest(out, frame_id, timestamp)
        host = images.cpu().numpy() if torch.is_tensor(images) else images
        vis = {c: host[c].copy() for c in range(host.shape[0])}
        for ann in anns:
            vis[ann["cid"]] = draw_skeleton_overlay(
                vis[ann["cid"]], ann["pose"], ann["scores"], ann["pid"]
            )
        from PIL import Image

        for c, img in vis.items():
            Image.fromarray(img).save(
                os.path.join(out_dir, f"{timestamp}_cam{c}.jpg")
            )

    n = 0
    if args.clip > 1:
        buf = []
        for item in frames():
            buf.append(item)
            if len(buf) < args.clip:
                continue
            fids = np.asarray([b[0] for b in buf], np.int32)
            with timer.time("track"):
                outs, _, _ = pipe.process_clip(
                    fids, torch.stack([torch.as_tensor(b[2]) for b in buf])
                )
            timer.counts["track"] += len(buf) - 1  # report per-frame
            n += len(buf)
            if args.save_images and cfg.save_image:
                outs = FrameOutput(*(x.cpu() for x in outs))
                for t, (fid, ts, images, _, _) in enumerate(buf):
                    out_t = FrameOutput(*(x[t] for x in outs))
                    save_overlays(out_t, fid, ts, images)
            buf.clear()
        trailing = buf
    else:
        trailing = frames()
    for frame_id, timestamp, images, _, _ in trailing:
        with timer.time("track"):
            out, dets, mask = pipe.process_frame(frame_id, images)
        n += 1
        if args.save_images and cfg.save_image:
            save_overlays(out, frame_id, timestamp, images)
    print(f"processed {n} frames")
    print(timer.report(num_views=len(cfg.dataset.folders_order)))


if __name__ == "__main__":
    main()
