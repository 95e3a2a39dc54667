"""Evaluation entry point (reference `src/evalmodel.py` equivalent).

    python -m tpupose_torch.cli.evalmodel --dataset CampusSeq1
    python -m tpupose_torch.cli.evalmodel --synthetic     # no data/weights
    python -m tpupose_torch.cli.evalmodel --device cpu --synthetic

Counterpart of `tpupose/cli/evalmodel.py`: the same flags, YAML configs
(`configs/<ds>/model_configs.yaml`), artifacts (predictions pkl +
per-camera 2D JSON) and PCP / Panoptic score tables. Runs on CUDA unless
`--device` names another device.
"""
from __future__ import annotations

import argparse
import os

import torch

from tpupose_torch.cli.common import (
    build_pipeline_real,
    dataset_frame_source,
    load_camera_parameter,
    result_path,
    run_eval_loop,
    skip_int8_calibration,
    synthetic_tracks,
)
from tpupose_torch.data.config import load_config, tracker_config_from
from tpupose_torch.eval import (
    evaluate_panoptic_from_pickle,
    evaluate_pcp_from_pickle,
    write_2d_result,
    write_3d_result,
)
from tpupose_torch.pipeline.facade import Pipeline, resolve_device
from tpupose_torch.utils.timing import StageTimer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="CampusSeq1",
                        help="CampusSeq1, Shelf, Panoptic")
    parser.add_argument("--config-dir", type=str, default="configs")
    parser.add_argument("--synthetic", action="store_true",
                        help="run on the built-in synthetic scene (replay mode)")
    parser.add_argument("--replay", type=str, default=None,
                        help="cached 2D detections dump pickle (reference "
                             "dump format); skips the NN backends")
    parser.add_argument("--frames", type=int, default=120)
    parser.add_argument("--clip", type=int, default=32,
                        help="buffer N frames and run them through the "
                             "two-stage clip pipeline (batched NN, then the "
                             "tracker over the clip); trailing partial clips "
                             "(and runs shorter than N) fall back to the "
                             "per-frame path with the same tracker state "
                             "evolution; 0 = per-frame")
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving mode: post-training-quantize the "
                             "backbones (tpupose_torch.models.quantize)")
    parser.add_argument("--int8-calib", type=int, default=8,
                        help="number of leading frames whose views feed the "
                             "--int8 activation-scale calibration pass AND "
                             "the post-quantize drift self-check (default 8; "
                             "<8 prints a warning)")
    parser.add_argument("--qat-steps", type=int, default=0,
                        help="with --int8: label-free QAT — fine-tune each "
                             "backbone for N straight-through steps to match "
                             "its own float outputs on the calibration "
                             "frames before requantizing (distill_qat); "
                             "0 = PTQ first, auto-escalating to QAT only if "
                             "the built-in int8-vs-bf16 self-check fails "
                             "(see --int8-on-drift)")
    parser.add_argument("--int8-on-drift", type=str, default="escalate",
                        choices=["escalate", "raise", "warn"],
                        help="when the post-quantize self-check (decoded "
                             "keypoints int8 vs bf16 on the calibration "
                             "frames) exceeds the drift gate: escalate = "
                             "auto-upgrade to distill-QAT (900 steps) and "
                             "re-check, raising if it still fails; raise = "
                             "refuse to serve; warn = print and continue "
                             "with the drifted models")
    parser.add_argument("--bundle", type=str, default=None,
                        help="pre-converted serving bundle dir (python -m "
                             "tpupose_torch.cli.convert); serving then reads "
                             "neither the .weights nor the .pth file")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda, which "
                             "must be present; cpu for a host without a card)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    timer = StageTimer()
    if args.synthetic:
        _run_synthetic(args, timer, device)
        return

    cfg = load_config(
        os.path.join(args.config_dir, args.dataset, "model_configs.yaml")
    )
    camera_parameter = load_camera_parameter(cfg)

    if args.replay:
        from tpupose_torch.data.replay import load_detection_dump, replay_frame_source

        width, height = _probe_image_size(cfg)
        cams = Pipeline.camera_set_from_parameter_dict(
            camera_parameter, width, height,
            num_cameras=len(cfg.dataset.folders_order),
        )
        tcfg = tracker_config_from(cfg, num_cameras=cams.num_cameras)
        pipe = Pipeline(cams, tcfg, device=device)
        source = replay_frame_source(
            cfg, load_detection_dump(args.replay), tcfg.max_dets,
            tcfg.num_joints,
        )
        image_hw = (height, width)
    else:
        # --device cuda decodes on the card (nvJPEG); a clip's worth ahead
        source = dataset_frame_source(cfg, True, timer, prefetch=max(4, args.clip),
                                      device=device)
        # peek first frame for image size
        first = next(source)
        images0 = first[2]
        pipe = build_pipeline_real(
            cfg, camera_parameter, images0.shape[2], images0.shape[1],
            bundle=args.bundle, device=device,
        )
        head = [first]
        if args.int8 and not skip_int8_calibration(args):
            # calibrate activation scales on the first --int8-calib frames'
            # views (all consumed frames are replayed into the eval loop)
            while len(head) < max(args.int8_calib, 1):
                try:
                    head.append(next(source))
                except StopIteration:
                    break
            print(f"--int8: calibrating + self-checking on frames "
                  f"{[int(item[0]) for item in head]}")
            pipe.quantize_models(
                torch.cat([torch.as_tensor(item[2]) for item in head]),
                qat_steps=args.qat_steps,
                on_drift=args.int8_on_drift,
            )
        image_hw = (images0.shape[1], images0.shape[2])

        def chained(head=head, source=source):
            yield from head
            yield from source

        source = chained()

    multi_poses3d, annotations = run_eval_loop(
        cfg, pipe, source, timer, clip=args.clip
    )

    pkl = result_path(cfg)
    write_3d_result(multi_poses3d, pkl)
    write_2d_result(
        image_hw, annotations,
        save_dir=os.path.join(cfg.output, cfg.dataset.test_dataset, "TrackResult"),
    )
    if cfg.dataset.test_dataset == "Panoptic":
        evaluate_panoptic_from_pickle(pkl, cfg.dataset.root)
    else:
        res = evaluate_pcp_from_pickle(
            cfg.dataset.eval_range, pkl, cfg.dataset.root, cfg.dataset.test_dataset
        )
        print(res["table"])
        print(f"Average PCP: {res['average'] * 100:.2f}")
    print(timer.report(num_views=len(cfg.dataset.folders_order)))


def _probe_image_size(cfg):
    """Image (width, height) from the first frame on disk.

    A replay run may have no images at all (cached-detections datasets):
    that case falls back to 1280x720 with a notice. A dataset that has
    image files which cannot be read is broken, and fails loudly rather
    than hand the tracker wrong-scale cameras."""
    from tpupose_torch.data.dataset import load_filenames, load_images

    try:
        datas = load_filenames(cfg.dataset)
    except OSError:
        datas = []
    if not datas or not datas[0]:
        print("note: no dataset images found (replay without frames); "
              "assuming 1280x720 for the camera rig")
        return 1280, 720
    # Images exist on disk -> they must be readable.
    images, _ = load_images(cfg.dataset.test_dataset, datas[0])
    return images[0].shape[1], images[0].shape[0]


def _run_synthetic(args, timer, device):
    from tpupose_torch.eval import coco2shelf3d, evaluate_pcp
    from tpupose_torch.tracking.tracker import FrameOutput

    scene, pipe, outs = synthetic_tracks(args.frames, timer, device)
    multi_poses3d, annotations = {}, []
    for t in range(scene.num_frames):
        out_t = FrameOutput(*(x[t] for x in outs))
        pts3d, ids, anns = pipe.harvest(out_t, t)
        multi_poses3d[t] = pts3d
        annotations.extend(anns)
    actors_gt = [
        [coco2shelf3d(scene.gt3d[t, a].T) for t in range(scene.num_frames)]
        for a in range(scene.num_actors)
    ]
    res = evaluate_pcp([[5, scene.num_frames]], multi_poses3d, actors_gt)
    print(res["table"])
    print(f"Average PCP: {res['average'] * 100:.2f}")
    print(timer.report(num_views=scene.num_cameras))


if __name__ == "__main__":
    main()
