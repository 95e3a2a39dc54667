"""Offline weight conversion: darknet / pose_hrnet checkpoints -> a serving
bundle.

    python -m tpupose_torch.cli.convert --dataset CampusSeq1 --out /path/bundle
    python -m tpupose_torch.cli.convert --device cpu --dataset Shelf --out b --int8

Counterpart of `tpupose/cli/convert.py`. Conversion happens once: the
bundle holds the BN-folded serving modules' state_dicts (`det.pt`,
`pose.pt`, written by `models.checkpoint.save_params`: tensors only, no
pickled modules) and a `bundle.json` manifest with the JAX package's keys,
pinning the model configs the weights were converted for. `evalmodel` /
`testmodel --bundle DIR` then serve from it without parsing the `.weights`
/ `.pth` files, folding BN or, for an `--int8` bundle, calibrating.

`main` reads the dataset's YAML (PyYAML) and, for `--int8`, its leading
frames (decoded on `--device` as `evalmodel` decodes them: nvJPEG on the
card, Pillow on the CPU); `convert_checkpoints` below it takes a `Config` and the
calibration frames and needs neither. A bundle of the JAX package (orbax
directories) does not load here: `load_bundle` says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os

import torch
from torch import nn

BUNDLE_MANIFEST = "bundle.json"
BUNDLE_FORMAT = 1
#: The two state_dict files of a bundle, by role.
BUNDLE_FILES = {"det": "det.pt", "pose": "pose.pt"}

#: Config fields that select a serving-time execution mode without
#: changing the stored weights: a bundle converted under one value loads
#: under another, so they are left out of the manifest match
#: (`pack_branch0` is not: packing changes the weights themselves).
SERVING_ONLY_FIELDS = frozenset({"decode_refine", "int8_resident"})


def _config_record(cfg) -> dict:
    """JSON-normalized dataclass fields (tuples -> lists, recursively)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def write_bundle(out_dir, det_cfg, detector, pose_cfg, pose_model,
                 provenance=None, dtype="bfloat16", quantized=False):
    """Save the folded serving modules' state_dicts and the manifest under
    `out_dir`; returns the manifest. Tensors are saved contiguous, so a
    model served channels-last (`Pipeline`) writes the bytes an NCHW one
    does."""
    from tpupose_torch.models.checkpoint import save_params

    os.makedirs(out_dir, exist_ok=True)
    for role, model in (("det", detector), ("pose", pose_model)):
        sd = model.state_dict()
        for k, v in sd.items():
            sd[k] = v.contiguous()
        save_params(os.path.join(out_dir, BUNDLE_FILES[role]), sd)
    manifest = {
        "format": BUNDLE_FORMAT,
        "folded": True,
        "dtype": dtype,
        "quantized": bool(quantized),
        "det_config": _config_record(det_cfg),
        "pose_config": _config_record(pose_cfg),
        "provenance": provenance or {},
    }
    with open(os.path.join(out_dir, BUNDLE_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def read_manifest(bundle_dir) -> dict:
    with open(os.path.join(bundle_dir, BUNDLE_MANIFEST)) as f:
        return json.load(f)


def _check_configs(manifest, det_cfg, pose_cfg):
    """Raise ValueError naming every field where the manifest's configs
    differ from the given ones (serving-only fields aside)."""
    for name, cfg in (("det_config", det_cfg), ("pose_config", pose_cfg)):
        want = {k: v for k, v in _config_record(cfg).items()
                if k not in SERVING_ONLY_FIELDS}
        got = {k: v for k, v in (manifest.get(name) or {}).items()
               if k not in SERVING_ONLY_FIELDS}
        if got != want:
            diff = {k: (got.get(k), want.get(k)) for k in sorted(set(got) | set(want))
                    if got.get(k) != want.get(k)}
            raise ValueError(
                f"bundle {name} does not match the dataset YAML config; "
                f"mismatched fields (bundle, yaml): {diff}")


def _skeleton(model: nn.Module, sd: dict) -> nn.Module:
    """`model` (a folded module on the meta device) with every conv whose
    saved keys are quantized (`<name>.weight_q`) replaced by an empty
    `QuantConv2d` of its shape, so that `sd` loads with strict=True."""
    from tpupose_torch.models.layers import Conv2d, QuantConv2d

    for name, conv in list(model.named_modules()):
        if not isinstance(conv, Conv2d) or name + ".weight_q" not in sd:
            continue
        cout = conv.out_channels
        with torch.device("meta"):
            q = QuantConv2d(torch.empty(conv.weight.shape, dtype=torch.int8),
                            torch.empty(cout), torch.empty(()),
                            torch.empty(cout) if name + ".bias" in sd else None,
                            stride=conv.stride[0], dilation=conv.dilation[0])
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, q)
    return model


def _restore(path, make):
    """The state_dict at `path` loaded (strict) into `make()`'s folded
    skeleton, built on the meta device and taking the saved tensors, on
    the CPU."""
    from tpupose_torch.models.checkpoint import restore_params
    from tpupose_torch.models.layers import fold_batchnorm

    sd = restore_params(path)
    with torch.device("meta"):
        model = fold_batchnorm(make())
    model = _skeleton(model, sd)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


def load_bundle(bundle_dir, det_cfg, pose_cfg):
    """Restore (detector, pose_model), the serving modules on the CPU,
    from a bundle, after checking that the manifest's configs match the
    YAML-derived ones (a bundle converted for another topology or
    resolution fails loudly instead of serving garbage). Raises ValueError
    for a bundle of another format, one written by the JAX package
    (orbax directories) among them."""
    from tpupose_torch.models.hrnet import HRNet
    from tpupose_torch.models.yolov3 import YOLOv3

    manifest = read_manifest(bundle_dir)
    if manifest.get("format") != BUNDLE_FORMAT:
        raise ValueError(f"unsupported bundle format {manifest.get('format')!r} "
                         f"(expected {BUNDLE_FORMAT})")
    paths = {role: os.path.join(bundle_dir, name) for role, name in BUNDLE_FILES.items()}
    if not all(os.path.isfile(p) for p in paths.values()):
        if all(os.path.isdir(os.path.join(bundle_dir, role)) for role in BUNDLE_FILES):
            raise ValueError(
                f"{bundle_dir} is a bundle of the JAX package (orbax checkpoint "
                "directories det/ and pose/); convert the checkpoints again with "
                "python -m tpupose_torch.cli.convert")
        raise ValueError(f"{bundle_dir}: missing {sorted(BUNDLE_FILES.values())}")
    _check_configs(manifest, det_cfg, pose_cfg)
    return (_restore(paths["det"], lambda: YOLOv3(det_cfg)),
            _restore(paths["pose"], lambda: HRNet(pose_cfg)))


def load_checkpoints(cfg, det_cfg, pose_cfg):
    """The config's darknet `.weights` detector and `pose_hrnet` `.pth`
    pose model on the CPU, BN folded into bf16 weights (exact for frozen
    statistics, half the weight traffic, and the form `quantize_models`
    expects). Returns (detector, pose_model, darknet header)."""
    from tpupose_torch.models.convert import (
        darknet_array_to_state_dict,
        load_hrnet_torch_checkpoint,
        read_darknet_file,
    )
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.models.yolov3 import YOLOv3

    header, data = read_darknet_file(cfg.detect_model.weight)
    detector = YOLOv3(det_cfg)
    detector.load_state_dict(darknet_array_to_state_dict(data, det_cfg), strict=True)
    pose_model = load_hrnet_torch_checkpoint(cfg.pose_model.checkpoint_file, pose_cfg)
    return (fold_batchnorm(detector, dtype=torch.bfloat16),
            fold_batchnorm(pose_model, dtype=torch.bfloat16), header)


def convert_checkpoints(cfg, out, int8=False, calib_images=None, camera_parameter=None,
                        qat_steps=0, on_drift="escalate", device=None, provenance=None,
                        qat_log=None):
    """Convert the config's checkpoints into a bundle at `out`; returns the
    manifest.

    bf16: the folded modules as `build_pipeline_real` serves them. With
    `int8`, they are quantized as `evalmodel --int8` does in process:
    `Pipeline.quantize_models` (calibration, the drift self-check,
    `qat_steps` / `on_drift`) on `calib_images`, (N, H, W, 3) uint8 frames
    (every view of the leading frames; a tensor or an array), on `device` (as `Pipeline`'s),
    with the rig of `camera_parameter` (a dict with 'P', 'K', 'RT'), so
    the bundle equals the in-process int8 models on those frames.
    `provenance` adds entries to the manifest's. Returns (manifest,
    detector, pose_model), the modules as written."""
    from tpupose_torch.cli.common import hrnet_config_from, yolo_config_from
    from tpupose_torch.data.config import tracker_config_from
    from tpupose_torch.pipeline.facade import Pipeline

    det_cfg, pose_cfg = yolo_config_from(cfg), hrnet_config_from(cfg)
    detector, pose_model, header = load_checkpoints(cfg, det_cfg, pose_cfg)
    dtype, quantized, calib_frames = "bfloat16", False, 0
    if int8:
        if calib_images is None or camera_parameter is None:
            raise ValueError("convert_checkpoints(int8=True) needs calib_images "
                             "and camera_parameter")
        calib_images = torch.as_tensor(calib_images)
        cams = Pipeline.camera_set_from_parameter_dict(
            camera_parameter, calib_images.shape[2], calib_images.shape[1],
            num_cameras=len(cfg.dataset.folders_order))
        pipe = Pipeline(cams, tracker_config_from(cfg, num_cameras=cams.num_cameras),
                        det_cfg, detector, pose_cfg, pose_model, device=device)
        pipe.quantize_models(calib_images, qat_steps=qat_steps, qat_log=qat_log,
                             on_drift=on_drift)
        detector, pose_model = pipe.detector, pipe.pose_model
        dtype, quantized, calib_frames = "int8", True, calib_images.shape[0]
    manifest = write_bundle(
        out, det_cfg, detector, pose_cfg, pose_model, dtype=dtype, quantized=quantized,
        provenance={
            "yolo_weights": os.path.abspath(cfg.detect_model.weight),
            "yolo_header": header,
            "hrnet_checkpoint": os.path.abspath(cfg.pose_model.checkpoint_file),
            "int8_calib_images": calib_frames,
            "int8_qat_steps": qat_steps if int8 else 0,
            **(provenance or {}),
        })
    return manifest, detector, pose_model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", type=str, default="CampusSeq1",
                        help="CampusSeq1, Shelf, Panoptic")
    parser.add_argument("--config-dir", type=str, default="configs")
    parser.add_argument("--out", type=str, required=True,
                        help="output bundle directory")
    parser.add_argument("--int8", action="store_true",
                        help="also post-training-quantize (PTQ) with "
                             "activation scales calibrated on dataset "
                             "frames: the bundle then is the int8 serving "
                             "configuration and serving needs no "
                             "calibration pass")
    parser.add_argument("--int8-calib", type=int, default=8,
                        help="number of leading dataset frames whose views "
                             "feed the --int8 calibration pass (the frames "
                             "evalmodel --int8 --int8-calib would use; "
                             "default 8; <8 prints a warning)")
    parser.add_argument("--qat-steps", type=int, default=0,
                        help="with --int8: label-free QAT, fine-tuning each "
                             "backbone for N straight-through steps against "
                             "its own float outputs on the calibration "
                             "frames before requantizing (distill_qat), "
                             "paid once at convert time; 0 = PTQ first, "
                             "escalating to QAT only if the int8-vs-bf16 "
                             "self-check fails")
    parser.add_argument("--int8-on-drift", type=str, default="escalate",
                        choices=["escalate", "raise", "warn"],
                        help="when the post-quantize self-check fails: "
                             "escalate = distill-QAT and re-check; raise = "
                             "refuse to write the bundle; warn = print and "
                             "write it anyway")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the --int8 calibration runs on "
                             "(default cuda, which must be present; cpu "
                             "for a host without a card)")
    args = parser.parse_args(argv)

    from tpupose_torch.cli.common import dataset_frame_source, load_camera_parameter
    from tpupose_torch.data.config import load_config
    from tpupose_torch.pipeline.facade import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(os.path.join(args.config_dir, args.dataset, "model_configs.yaml"))
    calib_images = camera_parameter = None
    if args.int8:
        # the leading dataset frames that `evalmodel --int8 --int8-calib N`
        # calibrates on, through the same `Pipeline.quantize_models`
        camera_parameter = load_camera_parameter(cfg)
        # decoded on `device` as evalmodel's frames are (nvJPEG on the card)
        source = dataset_frame_source(cfg, True, None, args.int8_calib, device=device)
        head = list(itertools.islice(source, max(args.int8_calib, 1)))
        source.close()
        if not head:
            raise FileNotFoundError("no dataset frames available for --int8 "
                                    f"calibration (dataset root {cfg.dataset.root!r})")
        print(f"--int8: calibrating + self-checking on frames "
              f"{[int(item[0]) for item in head]}")
        calib_images = torch.cat([torch.as_tensor(item[2]) for item in head])
    converted = convert_checkpoints(
        cfg, args.out, int8=args.int8, calib_images=calib_images,
        camera_parameter=camera_parameter, qat_steps=args.qat_steps,
        on_drift=args.int8_on_drift, device=device, provenance={"dataset": args.dataset},
        qat_log=lambda i, loss: print(f"  qat step {i}: loss={loss:.6f}"))
    manifest, det, pose = converted
    print(f"bundle written to {args.out}")
    print(f"  det:  {sum(t.numel() for t in det.state_dict().values()):,} folded "
          f"values  (yolo header {manifest['provenance']['yolo_header']})")
    print(f"  pose: {sum(t.numel() for t in pose.state_dict().values()):,} folded values")
    print("  manifest: " + json.dumps(
        {k: manifest[k] for k in ("format", "folded", "dtype", "quantized")}))


if __name__ == "__main__":
    main()
