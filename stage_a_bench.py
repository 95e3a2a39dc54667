#!/usr/bin/env python3
"""Time the PyTorch / CUDA port's clip path, and its stage A, on one card.

    python3 stage_a_bench.py                     # this checkout's tpupose_torch
    python3 stage_a_bench.py --root DIR --label parent

Imports `tpupose_torch` from DIR (by default the directory of this script),
so that one call on one card can time two commits in turns: unpack the
other commit with `git archive` into a directory that `.gitignore` lists
and run this script against each. The workload is chip_smoke.py's phases 5
and 6: YOLOv3-416 (max_candidates=4) and HRNet-W48 384x288 with random
weights from a seed, BN folded into bf16 weights, a 32-frame clip of 5
random 720x1280 uint8 views, the tracker at 4 / 12 / 24; bf16, then int8
after `Pipeline.quantize_models` on 8 frames of one view (on_drift="warn").
For each mode, after a warm-up clip: ms of two `process_clip` calls (host
clock to a sync) and fps, peak memory over them, STAGE_A_RUNS stage A calls
(`process_clip_nn`, to a sync) and their median, and in int8 the K2
launches of one stage A and their summed device time by CUDA events around
each `int8_conv_cuda` call and each K2a (`quantize_nhwc_cuda`) pass. It
prints one JSON line, the card's name and power limit in it. It needs a
CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

STAGE_A_RUNS = 5
FRAMES, VIEWS, HEIGHT, WIDTH = 32, 5, 720, 1280


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def timed_k2_stage_a(torch, k2, pipe, clip):
    """K2 launches, K2 ms and K2a ms in one stage A (events around each
    call; the inner K2a calls are counted inside K2's time too)."""
    events = {"k2": [], "k2a": []}
    inner = {"k2": k2.int8_conv_cuda, "k2a": k2.quantize_nhwc_cuda}

    def timed(name):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = inner[name](*args, **kw)
            end.record()
            events[name].append((start, end))
            return y
        return run

    k2.int8_conv_cuda, k2.quantize_nhwc_cuda = timed("k2"), timed("k2a")
    try:
        pipe.process_clip_nn(clip)
    finally:
        k2.int8_conv_cuda, k2.quantize_nhwc_cuda = inner["k2"], inner["k2a"]
    torch.cuda.synchronize()
    ms = {name: sum(s.elapsed_time(e) for s, e in ev) for name, ev in events.items()}
    return {"k2_calls": len(events["k2"]), "k2a_calls": len(events["k2a"]),
            "k2_ms": ms["k2"], "k2a_ms": ms["k2a"], "k2_minus_k2a_ms": ms["k2"] - ms["k2a"]}


def run_mode(torch, k2, pipe, clip, frame_ids):
    pipe.track_restart()
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clip_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        pipe.process_clip(frame_ids, clip)
        torch.cuda.synchronize()
        clip_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stage_a = []
    for _ in range(STAGE_A_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_clip_nn(clip)
        torch.cuda.synchronize()
        stage_a.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(clip_ms)
    return {"clip_ms": clip_ms, "ms_per_clip": ms, "fps": FRAMES * 1e3 / ms,
            "peak_mem_gib": peak, "stage_a_ms": stage_a,
            "stage_a_median_ms": statistics.median(stage_a)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                        help="directory holding the tpupose_torch package to time")
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("stage_a_bench: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import io
    from contextlib import redirect_stdout

    from tpupose_torch import kernels
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.models.hrnet import hrnet_init, hrnet_w48_config
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.models.yolov3 import YoloConfig, yolov3_init
    from tpupose_torch.ops import int8_conv as k2
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking.tracker import TrackerConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    det_cfg, pose_cfg = YoloConfig(max_candidates=4), hrnet_w48_config()
    tcfg = TrackerConfig(num_cameras=VIEWS, max_dets=4, max_tracks=12, max_hyp=24)
    cpu_gen = torch.Generator().manual_seed(0)
    detector = fold_batchnorm(yolov3_init(det_cfg, cpu_gen), dtype=torch.bfloat16)
    pose = fold_batchnorm(hrnet_init(pose_cfg, cpu_gen), dtype=torch.bfloat16)
    scene = make_scene(num_frames=1, num_cameras=VIEWS, num_actors=3, seed=0)
    cams = make_camera_set(scene.P, scene.K, scene.RT, WIDTH, HEIGHT)
    pipe = Pipeline(cams, tcfg, det_cfg, detector, pose_cfg, pose)
    gen = torch.Generator(device="cuda").manual_seed(0)
    clip = torch.randint(0, 256, (FRAMES, VIEWS, HEIGHT, WIDTH, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    frame_ids = torch.arange(FRAMES, dtype=torch.int32)
    out = {"label": args.label, "root": os.path.abspath(args.root), "card": card_line(),
           "torch": torch.__version__, "build_s": build_s}
    out["bf16"] = run_mode(torch, k2, pipe, clip, frame_ids)
    with redirect_stdout(io.StringIO()):
        pipe.quantize_models(clip[:8, 0].contiguous(), on_drift="warn")
    out["int8"] = run_mode(torch, k2, pipe, clip, frame_ids)
    counters = ("launches", "quantize_launches", "stem_launches")
    for c in counters:
        setattr(k2, c, 0)
    pipe.process_clip_nn(clip)
    torch.cuda.synchronize()
    out["int8"]["launches_per_stage_a"] = {c: getattr(k2, c) for c in counters}
    out["int8"]["k2_in_stage_a"] = timed_k2_stage_a(torch, k2, pipe, clip)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
