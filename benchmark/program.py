"""What the benchmark takes from the program, `tpupose_torch`: its
pipeline built from a configuration file and the benchmark's weights, its
launch counters, and its tracker configuration. Entries import this; the
reference never does."""
from __future__ import annotations

import time

import torch

from benchmark.harness import subseed
from benchmark.reference.pipeline import make_weights
from benchmark.traffic import generate


def build_kernels(ctx, names):
    """Compile the program's kernels the cell runs (only the first run in a
    checkout compiles; later ones find them built)."""
    from tpupose_torch import kernels

    t0 = time.perf_counter()
    built = kernels.build_all(names) if ctx.device.type == "cuda" else {}
    ctx.log(f"kernels: compiled {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    return built


def tracker_config(config, views, capacities):
    from tpupose_torch.tracking.tracker import TrackerConfig

    return TrackerConfig(num_cameras=views, **config["tracker"], **capacities)


def oracle_params(config, capacities):
    from benchmark.reference.oracle import TrackerParams

    return TrackerParams(**config["tracker"], max_tracks=capacities["max_tracks"])


def models(ctx):
    """The folded bf16 detector and pose net, with the weights the
    benchmark draws from the run's seed (the reference draws the same)."""
    from tpupose_torch.models.hrnet import HRNet, HRNetConfig
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.models.yolov3 import YOLOv3, YoloConfig

    cfg = ctx.config
    det_cfg = YoloConfig(**cfg["detector"])
    pose = dict(cfg["pose"], input_size=tuple(cfg["pose"]["input_size"]),
                stage_modules=tuple(cfg["pose"]["stage_modules"]))
    pose_cfg = HRNetConfig(**pose)
    ysd, hsd = make_weights(cfg, subseed(ctx.seed, "weights"), ctx.device)
    with torch.device("meta"):
        det, pose_model = YOLOv3(det_cfg), HRNet(pose_cfg)
    det.load_state_dict(ysd, strict=True, assign=True)
    pose_model.load_state_dict(hsd, strict=True, assign=True)
    del ysd, hsd
    return (det_cfg, fold_batchnorm(det, dtype=torch.bfloat16),
            pose_cfg, fold_batchnorm(pose_model, dtype=torch.bfloat16))


def rig_camera_set(rig, device):
    from tpupose_torch.geometry import make_camera_set

    P, K, RT = generate.rig_cameras(rig)
    return make_camera_set(P, K, RT, rig["width"], rig["height"], device=device)


def counters(since=None):
    """The program's launch and replay counters, less those of `since`."""
    from tpupose_torch.ops import heatmap, int8_conv, lap
    from tpupose_torch.runtime import graphs

    now = {"k1_launches": heatmap.launches, "k2_launches": int8_conv.launches,
           "k2a_launches": int8_conv.quantize_launches,
           "k2_stem_launches": int8_conv.stem_launches, "k3_launches": lap.launches,
           "graph_replays": sum(getattr(s, "replays", 0) for s in graphs.steps().values())}
    return {k: v - (since or {}).get(k, 0) for k, v in now.items()}



def judge_stage_a(ctx, images, heads, kps, mask, calib):
    """The stage-A numbers of the sampled images against the reference of
    the cell's configuration (int8 calibrated on `calib`); under the
    control of an int8 configuration, the int4 reference's own outputs
    stand in the program's place."""
    from benchmark.reference import judge
    from benchmark.reference.pipeline import Reference

    cfg = ctx.config
    bits = 8 if cfg["precision"] == "int8" else None
    weight_seed = subseed(ctx.seed, "weights")
    ref = Reference(cfg, weight_seed, ctx.device, bits=bits, calib=calib if bits else None)
    if ctx.control and bits:
        heads, kps, mask = Reference(cfg, weight_seed, ctx.device, bits=4,
                                     calib=calib).outputs(images)
    return judge.stage_a_numbers(ref, images, heads, kps, mask)


def judge_tracker(ctx, rig, capacities, sequences):
    """The tracker numbers of (program frames, detections, mask) sequences,
    each against the reference tracker run over its detections from a
    fresh state."""
    from benchmark.reference import judge, oracle

    P, K, RT = generate.rig_cameras(rig)
    pairs = []
    for prog, dets, mask in sequences:
        tracker = oracle.OracleTracker(oracle.rig(P, K, RT), oracle_params(ctx.config, capacities))
        pairs.append(list(zip(prog, judge.reference_frames(tracker, dets, mask))))
    return judge.tracker_numbers(pairs, ctx.spec.get("match_gate_m", 0.5),
                                 ctx.spec.get("off_m", 0.01))
