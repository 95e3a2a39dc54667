#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`tpupose_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel of `tpupose_torch/csrc` with nvcc for sm_90a, one
     process per source, all at once;
  3. K1 (heatmap decode) against its plain torch version on the card at the
     main path's shape (640, 17, 96, 72) f32, all three refinement modes,
     on random heatmaps with planted ties, plateaus, border peaks and
     non-finite neighbours (NaN compared as equal); median times of both;
  4. K2 (int8 conv): first K2a, its quantize-to-channels-last pass, against
     `quantize_nhwc_plain`, `torch.equal` on the whole output, at every
     distinct (Cin, H, W) input of the quantized convs of HRNet-W48 384x288
     and YOLOv3-416 at the main path's batch (640 crops, 160 images), bf16
     with a planted NaN and int8 (f32 too at branch 0's input); then K2
     against its plain version, `torch.equal`, at every distinct quantized
     conv shape at that batch, float input with a planted NaN and int8
     input, dequantize and requant-relu epilogue, plus one dilated shape:
     K2 (K2a + the implicit GEMM K2b, or the gather kernel for the stems'
     Cin of 3) runs on the whole batch, and its first and last 8 crops / 4
     images are held against the plain version on those images (the last
     ones sit at the largest offsets); then the times of K2, K2a and K2b
     alone, the plain version and the bf16 cuDNN conv, all on the whole
     batch, for HRNet branch 0's 3x3 48->48 at 96x72 (x640) and YOLO's 3x3
     128->256 at 52x52 (x160), and of the gather kernel and cuDNN at
     HRNet's stem 3x3 s2 3->64 at 384x288 (x640), each with its bound;
  5. the main path at full width in bf16: `Pipeline.process_clip` with
     YOLOv3-416 (max_candidates=4) and HRNet-W48 384x288, random weights
     from a seed, BN folded into bf16 weights, 32-frame clips of 5 views of
     720x1280 uint8 frames; the decode launch count, the stage A / stage B
     split, peak memory;
  6. the int8 main path: `Pipeline.quantize_models` on 8 frames of one view
     (on_drift="warn": random weights drift by design, so the self-check
     report is printed and not gated on), then `process_clip` twice on the
     same clip; K1, K2 and K2a launch counts (364 K2 and 362 K2a per clip
     expected), stage A, peak memory, and the int8-vs-bf16 keypoint shift
     (for information);
  7. int8-resident blocks: one HRNet-W48 forward with `int8_resident=True`
     on 8 crops in f32, each block held against the generic int8 block on
     the same input within the bound of the JAX package's test;
  8. the staged API: `process_frame` over the first 4 frames against
     `process_clip` on those frames (equal masks, detections within atol
     2e-2 / rtol 1e-3);
  9. the tracker on a synthetic scene with 5 views and 3 people: the same
     detections replayed through `person_track` on the card and on the CPU
     must give the same track ids, and 3 confirmed tracks;
 10. the evaluation CLI's loop (`tpupose_torch.cli.common`): full-width
     YOLOv3-416 and HRNet-W48 with random weights from a seed (BN not
     folded) written to a temporary directory as a darknet 0.2 `.weights`
     file and a `.pth` state_dict, a Config built by `config_from_raw`
     from SHELF_CONFIG, the pipeline built by `build_pipeline_real` (its
     folded weights `torch.equal` to the same models folded in memory),
     then `run_eval_loop` with --clip 32 over 68 in-memory frames of 5
     random 720x1280 views (2 clips through `process_clip`, 4 trailing
     frames through `process_frame`), in bf16 and again after
     `quantize_models` on all views of the first 8 frames
     (on_drift="warn"), each run with K1, K2 and K2a counted from 0 (6, 0,
     0 in bf16; 6, 6 x 364, 6 x 362 in int8); each run's first clip
     against `process_clip` + `harvest` (poses within 1e-3), the pkl and
     per-camera JSONs written and read back, PCP scored against the
     scene's ground truth; times per clip and per trailing frame, the
     StageTimer report, peak memory.
It prints a JSON line per phase, then `{"kernels": [...]}` (with each
kernel's launches in phase 10 as `cli_launches`), the
nvidia-smi line, and last `{"ok": true, "device": {...}}`. It needs a CUDA
card and the repository around it; without either it exits non-zero and
prints no result. The f32 comparisons run with TF32 off.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
H100_F32_OPS_PER_S = 67e12   # H100 SXM f32 outside the tensor cores
H100_INT8_OPS_PER_S = 1.979e15  # H100 SXM int8 tensor cores, dense
MAIN_CROPS, MAIN_IMAGES = 640, 160  # the main path's batches (HRNet, YOLO)
SUB_CROPS, SUB_IMAGES = 8, 4     # images of a K2 output held against plain

#: configs/Shelf/model_configs.yaml as yaml.safe_load reads it, but with
#: the bench's MAX_CANDIDATES of 4 (bench.py:95-110), so that the CLI's
#: stage A has phase 5's size. Phase 10 also points WEIGHT, CHECKPOINT_FILE,
#: ROOT and OUTPUT at its temporary files (`shelf_config`). Written out here
#: because the card's machine has no PyYAML.
SHELF_CONFIG = {
    "TEST_FUNCTION": "PersonTrack_Project3DPose",
    "PIPELINE_COMBINATION": {
        "DETECT_MODEL": "YOLOv3", "POSE_MODEL": "HRPose", "PERSON_MATCHER": "Iterative",
        "BUILD_3D": "SVD", "CONF_THRESHOLD": 0.5},
    "DATASET": {
        "DATA_TYPE": "Images", "TEST_DATASET": "Shelf",
        "FOLDERS_ORDER": ["Camera0", "Camera1", "Camera2", "Camera3", "Camera4"],
        "ROOT": "../CatchImage/Shelf", "CALIBRATION_FILE": "camera_parameter.pickle",
        "GT_FILE": "annotation_2d.json", "DATA_FORMAT": "*.jpg",
        "TEST_RANGE": [297, 601], "EVAL_RANGE": [[300, 601]]},
    "VISUALIZATION": True,
    "SAVE_IMAGE": True,
    "OUTPUT": "results/PersonPoseDetectResult",
    "DETECT_MODELS": {
        "YOLOV3": {"NAME": "YOLOv3", "CFG": "weights/yolo_v3.cfg",
                   "WEIGHT": "weights/yolov3.weights", "CLASS_NAMES": "weights/coco.names",
                   "SCORE_THRESH": 0.5, "NMS_THRESH": 0.4, "MAX_CANDIDATES": 4},
        "NONE": {"NAME": ""}},
    "POSE_MODELS": {
        "HRPOSE": {"NAME": "HRPose", "C": 48, "NUM_JOINTS": 17,
                   "CHECKPOINT_FILE": "weights/pose_hrnet_w48_384x288.pth",
                   "MODEL_NAME": "HRNet", "RESOLUTION": [384, 288]}},
    "PERSON_MATCHERS": {
        "ITERATIVE": {"NAME": "Iterative", "EPI_THRESHOLD": 60, "INIT_THRESHOLD": 30,
                      "JOINT_THRESHOLD": 60, "NUM_JOINTS": 17, "INIT_METHOD": "GD",
                      "N_INIT": 3, "MAX_AGE": 10, "W2D": 0.4, "ALPHA2D": 70, "W3D": 0.6,
                      "ALPHA3D": 0.15, "LAMBDA_A": 3, "LAMBDA_T": 5, "SIGMA": 0.3,
                      "ARM_SIGMA": 0.8}},
}


def shelf_config(root, weights, checkpoint):
    """SHELF_CONFIG with the dataset root and output under `root` and the
    two checkpoint paths."""
    import copy

    raw = copy.deepcopy(SHELF_CONFIG)
    raw["DATASET"]["ROOT"] = root
    raw["OUTPUT"] = os.path.join(root, "results")
    raw["DETECT_MODELS"]["YOLOV3"]["WEIGHT"] = weights
    raw["POSE_MODELS"]["HRPOSE"]["CHECKPOINT_FILE"] = checkpoint
    return raw


def fail(msg, code=1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup=3, reps=20):
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def planted_heatmaps(n, j, h, w, gen):
    """(n, j, h, w) f32 on the card: noise, one random peak per plane, and
    planted flat planes, plateaus, ties, border peaks and non-finite
    neighbours in the first ones."""
    import torch

    heat = torch.randn((n, j, h, w), generator=gen, device="cuda") * 0.1
    planes = heat.view(n * j, h * w)
    peak = torch.randint(0, h * w, (n * j,), generator=gen, device="cuda")
    planes[torch.arange(n * j, device="cuda"), peak] = 2.0 + torch.rand(
        n * j, generator=gen, device="cuda")
    p = heat.view(n * j, h, w)
    p[0] = 0.0                                   # flat: index 0
    p[1] = 1.0                                   # plateau of the max
    p[2, 3, :] = 5.0                             # all-equal row
    p[3, 7, 4] = p[3, 2, 9] = 4.0                # tie across rows
    p[4, 5, 8] = p[4, 5, 3] = 4.0                # tie within a row
    for k, (y, x) in enumerate([(0, 5), (h - 1, 5), (7, 0), (7, w - 1)]):
        p[5 + k, y, x] = 3.0                     # border peaks
    p[9] = 0.0
    p[9, 6, 6], p[9, 6, 7], p[9, 6, 5] = 3.0, 1.0, 1.0  # equal neighbours
    p[10] = -0.5                                 # negative plateau
    inf = float("inf")
    for k in range(11, 16):
        p[k] = 0.0
        p[k, 6, 6] = 3.0                         # a finite interior peak
    p[11, 6, 5] = p[11, 6, 7] = -inf             # -inf on both sides (x)
    p[12, 5, 6] = p[12, 7, 6] = -inf             # -inf on both sides (y)
    p[13] = -inf                                 # all -inf
    p[14, 6, 6] = inf                            # +inf peak
    p[15, 6, 7] = float("nan")                   # NaN neighbour (the peak)
    return heat


def check_equal_nan(got, ref, what, ulps=0):
    """got equals ref, NaN where ref is NaN, finite values within `ulps`
    units in the last place (exactly equal otherwise). Returns the largest
    difference over the entries that are finite in both."""
    import torch

    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        fail(f"{what}: NaN where the plain version has none, or the reverse")
    fin = torch.isfinite(ref)
    if not torch.equal(got[~fin & ~nan], ref[~fin & ~nan]):
        fail(f"{what}: infinities differ from the plain version")
    g, r = got[fin], ref[fin]
    err = torch.abs(g - r)
    tol = (torch.abs(torch.nextafter(r, torch.full_like(r, torch.inf)) - r) * ulps
           if ulps else torch.zeros_like(r))
    if bool((err > tol).any()):
        fail(f"{what}: differs from the plain version by up to {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def bound(moved, ops, ops_per_s):
    """The least time the card could take: bytes moved over its memory rate
    or operations over its peak rate for their type, whichever is longer."""
    t_bytes, t_ops = moved / H100_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "ops": ops}


def phase_kernel(th, torch, gen):
    n, j, h, w = 640, 17, 96, 72
    heat = planted_heatmaps(n, j, h, w, gen)
    xy = torch.rand((n, 2), generator=gen, device="cuda") * 1100.0
    wh = 20.0 + torch.rand((n, 2), generator=gen, device="cuda") * 500.0
    boxes = torch.cat([xy, xy + wh], 1).contiguous()
    result = {"modes": {}}
    max_err = 0.0
    for refine in ("raw", "quarter", "parabolic"):
        got = th.decode_heatmaps_cuda(heat, boxes, refine)
        ref = th.decode_heatmaps(heat, boxes, refine)
        torch.cuda.synchronize()
        check_equal_nan(got[..., 2], ref[..., 2], f"K1 {refine} scores")
        err = check_equal_nan(got[..., :2], ref[..., :2], f"K1 {refine} coordinates", ulps=1)
        if refine == "quarter" and not bool(torch.isnan(ref[11 // j, 11 % j, 0])):
            fail("K1 quarter: the plain version lost the NaN of inf - inf")
        max_err = max(max_err, err)
        ms = cuda_time_ms(lambda: th.decode_heatmaps_cuda(heat, boxes, refine))
        plain_ms = cuda_time_ms(lambda: th.decode_heatmaps(heat, boxes, refine), reps=10)
        result["modes"][refine] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    bytes_moved = heat.numel() * 4 + boxes.numel() * 4 + n * j * 3 * 4
    ops = heat.numel()  # one compare per element; refinement is per plane
    result.update(shape=[n, j, h, w], max_abs_err=max_err,
                  **bound(bytes_moved, ops, H100_F32_OPS_PER_S))
    return result


def conv_shapes(torch, model, x, skip):
    """{(cin, h, w, cout, k, stride, dilation): count} of the quantized convs
    (every Conv2d not in `skip`) in one forward of `model` on x."""
    from tpupose_torch.models.layers import Conv2d

    seen, hooks = {}, []

    def hook(mod, args):
        _, c, h, w = args[0].shape
        key = (c, h, w, mod.out_channels, mod.kernel_size[0], mod.stride[0],
               mod.dilation[0])
        seen[key] = seen.get(key, 0) + 1

    for m in model.modules():
        if isinstance(m, Conv2d) and m not in skip:
            hooks.append(m.register_forward_pre_hook(hook))
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def main_path_conv_shapes(torch):
    """The distinct quantized conv shapes of HRNet-W48 384x288 and
    YOLOv3-416, counted on meta tensors (no memory, no kernels)."""
    from tpupose_torch.models import quantize as tq
    from tpupose_torch.models.hrnet import HRNet, hrnet_w48_config
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.models.yolov3 import YOLOv3, YoloConfig

    with torch.device("meta"):
        hr = fold_batchnorm(HRNet(hrnet_w48_config()))
        yo = fold_batchnorm(YOLOv3(YoloConfig()))
        hr_shapes = conv_shapes(torch, hr, torch.empty(1, 3, 384, 288), tq.hrnet_skip_ids(hr))
        yo_shapes = conv_shapes(torch, yo, torch.empty(1, 3, 416, 416),
                                tq.yolo_skip_ids(yo, YoloConfig()))
    return hr_shapes, yo_shapes


def k2_operands(torch, k2, gen, shape, batch, in_dtype, out_dtype):
    """Random operands of one K2 call: weights, input, 1/x_scale and the
    epilogue vectors, scaled so that int8 outputs spread over [0, 127]. A
    float input holds a NaN in its first and its last image (quantized to
    0, as XLA converts NaN to int8)."""
    cin, h, w, cout, k, _, _ = shape
    kk = cin * k * k
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.int8)
    if in_dtype == torch.int8:
        x = torch.randint(-127, 128, (batch, cin, h, w), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        code_std = 73.3
    else:
        x = (torch.randn((batch, cin, h, w), generator=gen, device="cuda") * 2.0).to(in_dtype)
        x[0, 0, h // 2, w // 2] = x[-1, -1, h // 3, w // 3] = float("nan")
        code_std = 2.0 * 127.0 / 8.0
    inv = torch.tensor([127.0 / 8.0], device="cuda")
    acc_std = code_std * 73.3 * kk ** 0.5
    rnd = torch.rand((cout,), generator=gen, device="cuda") + 0.5
    if out_dtype == torch.int8:
        mul, add = rnd * (40.0 / acc_std), torch.randn((cout,), generator=gen, device="cuda") * 10
    else:
        mul, add = rnd / acc_std, torch.randn((cout,), generator=gen, device="cuda")
    return wq, k2.pack_weight(wq), x, inv, mul, add


def k2a_input(torch, gen, shape, batch, dtype):
    """A K2a input of (cin, h, w) at `batch`: int8 codes, or a float tensor
    with a NaN in its first and its last image."""
    cin, h, w = shape
    if dtype == torch.int8:
        return torch.randint(-127, 128, (batch, cin, h, w), generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)
    x = (torch.randn((batch, cin, h, w), generator=gen, device="cuda") * 2.0).to(dtype)
    x[0, 0, h // 2, w // 2] = x[-1, -1, h // 3, w // 3] = float("nan")
    return x


def phase_k2a(torch, gen, hr_shapes, yo_shapes):
    """K2a against its plain version, torch.equal on the whole output, at
    every distinct (Cin, H, W) of the quantized convs at the main path's
    batch: bf16 and int8 inputs, and f32 at branch 0's input."""
    from tpupose_torch.ops import int8_conv as k2

    inv = torch.tensor([127.0 / 8.0], device="cuda")
    inputs = sorted({(sh[:3], MAIN_CROPS) for sh in hr_shapes}
                    | {(sh[:3], MAIN_IMAGES) for sh in yo_shapes})
    checked = 0
    for shape, batch in inputs:
        dtypes = [torch.bfloat16, torch.int8]
        if shape == (48, 96, 72):
            dtypes.append(torch.float32)
        for dtype in dtypes:
            x = k2a_input(torch, gen, shape, batch, dtype)
            got = k2.quantize_nhwc_cuda(x, inv)
            ref = k2.quantize_nhwc_plain(x, inv)
            if not torch.equal(got, ref):
                fail(f"K2a {shape} batch {batch} {dtype}: differs from the plain version "
                     f"in {int((got != ref).sum())} codes")
            if dtype != torch.int8 and got[0, shape[1] // 2, shape[2] // 2, 0] != 0:
                fail(f"K2a {shape} {dtype}: the planted NaN did not quantize to 0")
            checked += 1
            del x, got, ref
    return {"checked": checked, "distinct_inputs": len(inputs), "max_abs_err": 0.0}


def time_k2(torch, gen, shape, batch, with_plain=True):
    """Times of one conv shape at `batch`, bf16 in and out: K2 as the main
    path calls it, and, on the channels-last path, K2a and K2b alone; the
    plain version and the bf16 cuDNN conv; each kernel with its bound."""
    import torch.nn.functional as F

    from tpupose_torch.ops import int8_conv as k2

    b16 = torch.bfloat16
    cin, h, w, cout, k, stride, dil = shape
    wq, wk, x, inv, mul, add = k2_operands(torch, k2, gen, shape, batch, b16, b16)
    y = k2.int8_conv_cuda(x, wk, (k, k), inv, mul, add, b16, stride, dil)
    vectors = 2 * cout * 4 + 4
    ops = 2 * y.numel() * cin * k * k
    out = {"shape": [batch, cin, h, w, cout, k, stride],
           "ms": cuda_time_ms(lambda: k2.int8_conv_cuda(x, wk, (k, k), inv, mul, add, b16,
                                                        stride, dil), reps=10),
           **bound(x.numel() * 2 + wq.numel() + y.numel() * 2 + vectors, ops,
                   H100_INT8_OPS_PER_S)}
    if k2.channels_last(cin):
        xq = k2.quantize_nhwc_cuda(x, inv)
        out["k2a"] = {"ms": cuda_time_ms(lambda: k2.quantize_nhwc_cuda(x, inv), reps=10),
                      **bound(x.numel() * 2 + xq.numel(), 4 * x.numel(), H100_F32_OPS_PER_S)}
        out["k2b"] = {"ms": cuda_time_ms(lambda: k2.gemm_nhwc_cuda(
                          xq, wk, (k, k), mul, add, b16, stride, dil), reps=10),
                      **bound(xq.numel() + wq.numel() + y.numel() * 2 + vectors, ops,
                              H100_INT8_OPS_PER_S)}
        out["design_bytes"] = out["k2a"]["bytes"] + out["k2b"]["bytes"]
        out["design_bound_ms"] = out["design_bytes"] / H100_BYTES_PER_S * 1e3
        if with_plain:
            out["k2a"]["plain_ms"] = cuda_time_ms(lambda: k2.quantize_nhwc_plain(x, inv),
                                                  warmup=1, reps=5)
        del xq
    if with_plain:
        out["plain_ms"] = cuda_time_ms(
            lambda: k2.int8_conv_plain(x, wq, inv, mul, add, b16, stride, dil),
            warmup=1, reps=3)
    wb = torch.randn((cout, cin, k, k), generator=gen, device="cuda").to(b16)
    out["bf16_cudnn_ms"] = cuda_time_ms(
        lambda: F.conv2d(x, wb, stride=stride, padding=k // 2, dilation=dil), reps=10)
    return out


def phase_k2(torch, gen, card):
    """K2a and K2 against their plain versions at every quantized conv shape
    of the main path and at its batch, then timed at three shapes."""
    from tpupose_torch.ops import int8_conv as k2

    hr_shapes, yo_shapes = main_path_conv_shapes(torch)
    if (len(hr_shapes), sum(hr_shapes.values()), len(yo_shapes), sum(yo_shapes.values())) \
            != (27, 292, 20, 72):
        fail(f"quantized conv shapes: HRNet {len(hr_shapes)} / {sum(hr_shapes.values())}, "
             f"YOLO {len(yo_shapes)} / {sum(yo_shapes.values())}, expected 27 / 292, 20 / 72")
    k2a = phase_k2a(torch, gen, hr_shapes, yo_shapes)
    b16, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    modes = [(b16, b16), (b16, i8), (i8, b16), (i8, i8)]
    dilated = (48, 96, 72, 48, 3, 1, 2)
    cases = ([(sh, MAIN_CROPS, SUB_CROPS, modes) for sh in sorted(hr_shapes)]
             + [(sh, MAIN_IMAGES, SUB_IMAGES, modes) for sh in sorted(yo_shapes)]
             + [(dilated, MAIN_CROPS, SUB_CROPS, modes + [(f32, f32), (f32, i8)])])
    checked, gathered, max_err = 0, 0, 0.0
    for shape, batch, sub, shape_modes in cases:
        _, _, _, _, k, stride, dil = shape
        for in_dtype, out_dtype in shape_modes:
            wq, wk, x, inv, mul, add = k2_operands(torch, k2, gen, shape, batch, in_dtype, out_dtype)
            got = k2.int8_conv_cuda(x, wk, (k, k), inv, mul, add, out_dtype, stride, dil)
            what = f"K2 {shape} batch {batch} {in_dtype} -> {out_dtype}"
            if out_dtype != i8 and not bool(torch.isfinite(got).all()):
                fail(f"{what}: non-finite outputs")
            for first in (0, batch - sub):
                part = slice(first, first + sub)
                ref = k2.int8_conv_plain(x[part], wq, inv, mul, add, out_dtype, stride, dil)
                err = float((got[part].float() - ref.float()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got[part], ref):
                    fail(f"{what}: images {first}..{first + sub - 1} differ from the "
                         f"plain version by up to {err}")
                if out_dtype == i8 and not (ref.min() == 0 and ref.max() == 127):
                    fail(f"{what}: the requant check does not span [0, 127]")
            checked += 1
            gathered += not k2.channels_last(shape[0])
            del x, got
    timed = {name: time_k2(torch, gen, shape, batch, with_plain)
             for name, shape, batch, with_plain in (
                 ("hrnet_branch0_3x3_48", (48, 96, 72, 48, 3, 1, 1), MAIN_CROPS, True),
                 ("yolo_3x3_128_256", (128, 52, 52, 256, 3, 1, 1), MAIN_IMAGES, True),
                 ("hrnet_stem_3x3_s2_3_64", (3, 384, 288, 64, 3, 2, 1), MAIN_CROPS, False))}
    return {"card": card, "checked": checked, "checked_on_gather_path": gathered,
            "k2a": k2a, "batch": {"hrnet_w48": MAIN_CROPS, "yolov3_416": MAIN_IMAGES},
            "compared_images": {"hrnet_w48": 2 * SUB_CROPS, "yolov3_416": 2 * SUB_IMAGES},
            "distinct_shapes": {
                "hrnet_w48": len(hr_shapes), "yolov3_416": len(yo_shapes), "dilated": 1},
            "quantized_convs": {"hrnet_w48": sum(hr_shapes.values()),
                                "yolov3_416": sum(yo_shapes.values())},
            "max_abs_err": max_err, "timed": timed, "library_ms": None}


def phase_main_path(torch, gen, card):
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.models.hrnet import hrnet_init, hrnet_w48_config
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.models.yolov3 import YoloConfig, yolov3_init
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import lap
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking.tracker import TrackerConfig, track_clip

    views, frames, height, width = 5, 32, 720, 1280
    det_cfg = YoloConfig(max_candidates=4)
    pose_cfg = hrnet_w48_config()
    tcfg = TrackerConfig(num_cameras=views, max_dets=4, max_tracks=12, max_hyp=24)
    cpu_gen = torch.Generator().manual_seed(0)
    detector = fold_batchnorm(yolov3_init(det_cfg, cpu_gen), dtype=torch.bfloat16)
    pose = fold_batchnorm(hrnet_init(pose_cfg, cpu_gen), dtype=torch.bfloat16)
    scene = make_scene(num_frames=1, num_cameras=views, num_actors=3, seed=0)
    cams = make_camera_set(scene.P, scene.K, scene.RT, width, height)
    pipe = Pipeline(cams, tcfg, det_cfg, detector, pose_cfg, pose)
    clip = torch.randint(0, 256, (frames, views, height, width, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    frame_ids = torch.arange(frames, dtype=torch.int32)

    t0 = time.perf_counter()
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    # stage split: stage A alone, then stage B on its detections
    t0 = time.perf_counter()
    dets, mask = pipe.process_clip_nn(clip)
    torch.cuda.synchronize()
    stage_a_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with torch.inference_mode():
        track_clip(tcfg, pipe.cams, pipe.state, dets, mask, frame_ids.cuda())
    torch.cuda.synchronize()
    stage_b_ms = (time.perf_counter() - t0) * 1e3

    # the main path: counts from 0, two clips, counts read right after
    torch.cuda.reset_peak_memory_stats()
    th.launches = 0
    lap.host_syncs = 0
    clip_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        outs, dets, mask = pipe.process_clip(frame_ids, clip)
        torch.cuda.synchronize()
        clip_ms.append((time.perf_counter() - t0) * 1e3)
    launches, syncs = th.launches, lap.host_syncs
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches < 1:
        fail("the main path never launched the heatmap decode kernel")

    check_clip_outputs(torch, outs, dets, mask, frames, views, tcfg)
    ms = statistics.median(clip_ms)
    return {
        "config": "YOLOv3-416 (max_candidates=4) + HRNet-W48 384x288, BN folded, "
                  "bf16; 32 frames x 5 views x 720x1280 uint8",
        "card": card, "first_clip_s": first_s, "clip_ms": clip_ms,
        "ms_per_clip": ms, "fps": frames * 1e3 / ms,
        "stage_a_ms": stage_a_ms, "stage_b_ms": stage_b_ms,
        "stage_b_ms_per_frame": stage_b_ms / frames,
        "decode_launches": launches, "clips": 2,
        "host_syncs_per_frame": syncs / (2 * frames),
        "detections_valid": int(mask.sum()), "peak_mem_gib": peak_gib,
    }, (pipe, clip, frame_ids, dets, mask)


def check_clip_outputs(torch, outs, dets, mask, frames, views, tcfg):
    """Shapes and finiteness of a full-width process_clip result."""
    T, J = tcfg.max_tracks, tcfg.num_joints
    expect = {"valid": (frames, T), "track_id": (frames, T), "pose3d": (frames, T, J, 3),
              "n_views": (frames, T, J), "pose2d": (frames, T, views, J, 3),
              "pose2d_now": (frames, T, views)}
    for field, shape in expect.items():
        if tuple(getattr(outs, field).shape) != shape:
            fail(f"FrameOutput.{field} has shape {tuple(getattr(outs, field).shape)}")
    if tuple(dets.shape) != (frames, views, 4, J, 3) or tuple(mask.shape) != (frames, views, 4):
        fail(f"detections have shapes {tuple(dets.shape)} and {tuple(mask.shape)}")
    if not (torch.isfinite(dets).all() and torch.isfinite(outs.pose3d).all()):
        fail("non-finite detections or poses")


def phase_int8_path(torch, card, main):
    """int8 serving on the main path's pipeline: quantize_models on 8
    frames of one view, then process_clip twice on the same clip."""
    import io
    from contextlib import redirect_stdout

    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2
    from tpupose_torch.ops import lap
    from tpupose_torch.tracking.tracker import track_clip

    pipe, clip, frame_ids, dets_bf16, mask_bf16 = main
    frames, views = clip.shape[0], clip.shape[1]
    tcfg = pipe.tracker_cfg
    log = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with redirect_stdout(log):
        # random weights drift by design: report the check, do not gate on it
        pipe.quantize_models(clip[:8, 0].contiguous(), on_drift="warn")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    print(log.getvalue().rstrip(), flush=True)
    report = dict(pipe.last_quant_report)
    pipe.track_restart()

    t0 = time.perf_counter()
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dets, mask = pipe.process_clip_nn(clip)
    torch.cuda.synchronize()
    stage_a_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with torch.inference_mode():
        track_clip(tcfg, pipe.cams, pipe.state, dets, mask, frame_ids.cuda())
    torch.cuda.synchronize()
    stage_b_ms = (time.perf_counter() - t0) * 1e3

    # the int8 main path: counts from 0, two clips, counts read right after
    torch.cuda.reset_peak_memory_stats()
    th.launches = 0
    k2.launches = 0
    k2.quantize_launches = 0
    lap.host_syncs = 0
    clip_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        outs, dets, mask = pipe.process_clip(frame_ids, clip)
        torch.cuda.synchronize()
        clip_ms.append((time.perf_counter() - t0) * 1e3)
    k1_launches, k2_launches, syncs = th.launches, k2.launches, lap.host_syncs
    k2a_launches = k2.quantize_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if k1_launches < 1 or (k2_launches, k2a_launches) != (2 * 364, 2 * 362):
        fail(f"two int8 clips launched K1 {k1_launches}, K2 {k2_launches} and K2a "
             f"{k2a_launches} times, expected >= 1, 728 and 724")
    check_clip_outputs(torch, outs, dets, mask, frames, views, tcfg)
    k2_ms, k2_calls = k2_time_in_stage_a(torch, pipe, clip)
    both = (mask & mask_bf16)
    shift = torch.linalg.norm(dets[..., :2] - dets_bf16[..., :2], dim=-1)[both]
    ms = statistics.median(clip_ms)
    return {
        "config": "the main path's pipeline after quantize_models (int8 YOLOv3-416 and "
                  "HRNet-W48 through K2, float heads)",
        "card": card, "quantize_s": quantize_s, "self_check": report,
        "first_clip_s": first_s, "clip_ms": clip_ms, "ms_per_clip": ms,
        "fps": frames * 1e3 / ms, "stage_a_ms": stage_a_ms, "stage_b_ms": stage_b_ms,
        "k2_launches": k2_launches, "k2_launches_per_clip": k2_launches / 2,
        "quantize_launches": k2a_launches, "quantize_launches_per_clip": k2a_launches / 2,
        "k1_launches": k1_launches, "clips": 2,
        "k2_ms_in_stage_a": k2_ms, "k2_calls_timed": k2_calls,
        "host_syncs_per_frame": syncs / (2 * frames),
        "detections_valid": int(mask.sum()), "masks_equal_bf16": bool(torch.equal(mask, mask_bf16)),
        "kps_shift_vs_bf16_px": {"median": float(shift.median()), "p95": float(shift.quantile(0.95)),
                                 "max": float(shift.max()), "n": int(shift.numel())},
        "peak_mem_gib": peak_gib,
    }


def k2_time_in_stage_a(torch, pipe, clip):
    """Summed device time of the K2 launches in one int8 stage A, by CUDA
    events around each launch (after the counted runs; no host syncs)."""
    from tpupose_torch.ops import int8_conv as k2

    events, inner = [], k2.int8_conv_cuda

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = inner(*args, **kw)
        end.record()
        events.append((start, end))
        return y

    k2.int8_conv_cuda = timed
    try:
        pipe.process_clip_nn(clip)
    finally:
        k2.int8_conv_cuda = inner
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events), len(events)


def phase_resident(torch, card, pipe, clip):
    """One HRNet-W48 forward with int8_resident=True on SUB_CROPS crops in
    f32; each fused block against the generic int8 block on its input.

    Bound (tests/test_quantize.py, test_int8_resident_block_matches_generic_path):
    the two paths round the same value of each inter-conv tensor, so its
    codes differ by at most one, and the output by at most
    3 * step * max_co sum|w| of the conv after it (3 codes, loosely). For a
    bottleneck the mid-1 code moves conv2's output by x_scale2 * |w2|_1,
    i.e. that over x_scale3 codes of mid 2, plus its own rounding:
    3 * (x_scale2 * |w2|_1 + x_scale3) * |w3|_1."""
    import dataclasses

    from tpupose_torch.models.hrnet import BasicBlock, Bottleneck
    from tpupose_torch.pipeline.facade import _pose_crops

    model = pipe.pose_model
    with torch.inference_mode():
        x = clip[:2, 0].to(torch.bfloat16) / 255.0
        boxes, _, _ = pipe.person_detect(clip[:2, 0])
        _, crops = _pose_crops(pipe.pose_cfg, x, boxes)
    crops = crops[:SUB_CROPS].float()

    def l1(conv):
        return float((conv.weight_q.float().abs() * conv.w_scale[:, None, None, None])
                     .sum(dim=(1, 2, 3)).max())

    worst, checked = [0.0, 0.0], [0]

    def hook(block, args, out):
        x_in = args[0]
        generic = block.forward(x_in, False)
        if isinstance(block, BasicBlock):
            bound = 3 * float(block.conv2.x_scale) * l1(block.conv2)
        else:
            bound = 3 * (float(block.conv2.x_scale) * l1(block.conv2)
                         + float(block.conv3.x_scale)) * l1(block.conv3)
        err = float((out - generic).abs().max())
        if err > bound:
            fail(f"int8-resident {type(block).__name__}: differs from the generic int8 "
                 f"block by {err} > {bound}")
        worst[0] = max(worst[0], err)
        worst[1] = max(worst[1], err / bound)
        checked[0] += 1

    cfg = model.cfg
    with torch.inference_mode():
        generic_heat = model(crops, torch.float32)
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (BasicBlock, Bottleneck))]
    try:
        with torch.inference_mode():
            model.cfg = dataclasses.replace(cfg, int8_resident=True)
            resident_heat = model(crops, torch.float32)
    finally:
        model.cfg = cfg
        for h in hooks:
            h.remove()
    if checked[0] != len(hooks) or not checked[0]:
        fail(f"int8-resident: {checked[0]} of {len(hooks)} blocks checked")
    return {"card": card, "crops": SUB_CROPS, "blocks_checked": checked[0],
            "max_abs_diff": worst[0], "max_diff_over_bound": worst[1],
            "heatmap_max_abs_diff": float((resident_heat - generic_heat).abs().max())}


def phase_staged(torch, card, pipe, clip, frame_ids):
    """process_frame over the first 4 frames against process_clip on them."""
    n = 4
    pipe.track_restart()
    outs_c, dets_c, mask_c = pipe.process_clip(frame_ids[:n], clip[:n])
    pipe.track_restart()
    worst = 0.0
    for t in range(n):
        out, dets, mask = pipe.process_frame(t, clip[t])
        if not torch.equal(mask, mask_c[t]):
            fail(f"process_frame {t}: masks differ from process_clip")
        if not torch.equal(out.valid, outs_c.valid[t]):
            fail(f"process_frame {t}: track validity differs from process_clip")
        err = (dets - dets_c[t]).abs()
        if bool((err > 2e-2 + 1e-3 * dets_c[t].abs()).any()):
            fail(f"process_frame {t}: detections differ from process_clip by up to "
                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    return {"card": card, "frames": n, "masks_equal": True, "dets_max_abs_diff": worst}


def phase_tracker(torch, card):
    import tpupose_torch.tracking.tracker as tt
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.ops import lap
    from tpupose_torch.pipeline import Pipeline

    frames, views, D = 24, 5, 4
    scene = make_scene(num_frames=frames, num_cameras=views, num_actors=3, seed=0)
    cams = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    cfg = tt.TrackerConfig(num_cameras=views, max_dets=D, max_tracks=12, max_hyp=24)
    gpu = Pipeline(cams, cfg, device="cuda")
    cpu = Pipeline(cams, cfg, device="cpu")

    # time the LAP inside the card's tracker steps (synchronizing wrapper)
    lap_s = [0.0]
    plain_lap = tt.masked_lap

    def timed_lap(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_lap(*args, **kw)
        torch.cuda.synchronize()
        lap_s[0] += time.perf_counter() - t0
        return out

    step_s, syncs, err = 0.0, 0, 0.0
    for t in range(frames):
        dets = torch.zeros((views, D, 17, 3))
        mask = torch.zeros((views, D), dtype=torch.bool)
        dets[:, :3] = torch.as_tensor(scene.detections[t])
        mask[:, :3] = torch.as_tensor(scene.visible[t])
        tt.masked_lap = timed_lap
        lap.host_syncs = 0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_g = gpu.person_track(t, dets, mask)
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t0
        finally:
            tt.masked_lap = plain_lap
        syncs += lap.host_syncs
        out_c = cpu.person_track(t, dets, mask)
        for field in ("track_id", "valid"):
            if not torch.equal(getattr(out_g, field).cpu(), getattr(out_c, field)):
                fail(f"tracker frame {t}: {field} differs between the card and the CPU")
        if bool(out_c.valid.any()):
            err = max(err, float(torch.abs(out_g.pose3d.cpu() - out_c.pose3d)[out_c.valid].max()))
    confirmed = int(out_g.valid.sum())
    if confirmed != 3:
        fail(f"the tracker confirmed {confirmed} tracks on a 3-person scene")
    return {"card": card, "frames": frames, "confirmed": confirmed,
            "ms_per_frame": step_s * 1e3 / frames,
            "lap_share": lap_s[0] / step_s, "host_syncs_per_frame": syncs / frames,
            "pose3d_max_abs_diff_m": err}


CLI_FRAMES, CLI_CLIP, CLI_CALIB = 68, 32, 8  # 2 clips + 4 trailing frames
CLI_HEIGHT, CLI_WIDTH = 720, 1280
#: K1, K2 and K2a launches per `process_clip` or `process_frame` call (one
#: stage A batch each): one decode, and in int8 the 364 quantized convs of
#: YOLOv3-416 and HRNet-W48, 362 of them through K2a (phase 6's counts).
STEP_LAUNCHES = {
    "bf16": {"heatmap.launches": 1, "int8_conv.launches": 0,
             "int8_conv.quantize_launches": 0},
    "int8": {"heatmap.launches": 1, "int8_conv.launches": 364,
             "int8_conv.quantize_launches": 362},
}


def jitter_bn(torch, model, gen):
    """Random BN statistics and affine terms (scale <= 1), so that folding
    them is not the identity and a misordered darknet BN block shows."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.9, 1.0, generator=gen)
                m.bias.normal_(0.0, 0.01, generator=gen)
                m.running_mean.normal_(0.0, 0.01, generator=gen)
                m.running_var.uniform_(1.0, 1.1, generator=gen)
    return model


def write_checkpoints(torch, root, det_cfg, pose_cfg):
    """Full-width random YOLOv3 and HRNet from a seed, BN not folded,
    written as a darknet 0.2 `.weights` file and a plain `.pth`
    state_dict. Returns the two paths and the models."""
    from tpupose_torch.models import convert
    from tpupose_torch.models.hrnet import hrnet_init
    from tpupose_torch.models.yolov3 import yolov3_init

    gen = torch.Generator().manual_seed(10)
    detector = jitter_bn(torch, yolov3_init(det_cfg, gen), gen)
    pose = jitter_bn(torch, hrnet_init(pose_cfg, gen), gen)
    weights = os.path.join(root, "yolov3.weights")
    convert.write_darknet_file(
        weights, {"major": 0, "minor": 2, "revision": 0, "seen": 32013312},
        convert.state_dict_to_darknet_array(detector.state_dict(), det_cfg))
    checkpoint = os.path.join(root, "pose_hrnet_w48_384x288.pth")
    torch.save(pose.state_dict(), checkpoint)
    return weights, checkpoint, detector, pose


def check_state_dicts_equal(torch, loaded, ref, what):
    got, want = loaded.state_dict(), ref.state_dict()
    if set(got) != set(want):
        fail(f"{what}: the loaded state_dict's keys differ from the in-memory model's")
    for k, v in want.items():
        if not torch.equal(got[k].cpu(), v.cpu()):
            fail(f"{what}: {k} differs from the in-memory model folded the same way")
    return len(want)


def cli_loop(torch, cfg, pipe, frames, card, counters):
    """`cli.common.run_eval_loop` over the in-memory frames in CLI_CLIP-frame
    clips, with every counter of `counters` (module, attribute) set to 0
    just before and read just after; each clip and each trailing frame
    timed to a device sync."""
    from tpupose_torch.cli import common as cli
    from tpupose_torch.ops import lap
    from tpupose_torch.utils.timing import StageTimer

    calls = {"process_clip": [], "process_frame": []}

    def timed(name):
        fn = getattr(pipe, name)

        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            calls[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def source():
        for t in range(frames.shape[0]):
            yield t, t, frames[t], None, None

    pipe.track_restart()
    pipe.process_clip, pipe.process_frame = timed("process_clip"), timed("process_frame")
    timer = StageTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for module, attr in counters:
        setattr(module, attr, 0)
    lap.host_syncs = 0
    t0 = time.perf_counter()
    try:
        multi_poses3d, annotations = cli.run_eval_loop(cfg, pipe, source(), timer,
                                                       clip=CLI_CLIP)
        torch.cuda.synchronize()
    finally:
        del pipe.process_clip, pipe.process_frame
    loop_s = time.perf_counter() - t0
    syncs = lap.host_syncs
    launches = {f"{module.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(module, attr)
                for module, attr in counters}
    n_clips, n_tail = divmod(frames.shape[0], CLI_CLIP)
    if (len(calls["process_clip"]), len(calls["process_frame"])) != (n_clips, n_tail):
        fail(f"the CLI loop made {len(calls['process_clip'])} process_clip and "
             f"{len(calls['process_frame'])} process_frame calls, expected {n_clips} "
             f"and {n_tail}")
    if sorted(multi_poses3d) != list(range(frames.shape[0])):
        fail("the CLI loop did not harvest every frame")
    return {
        "card": card, "loop_s": loop_s, "clip_ms": calls["process_clip"],
        "ms_per_clip": statistics.median(calls["process_clip"]),
        "frame_ms": calls["process_frame"],
        "ms_per_trailing_frame": statistics.median(calls["process_frame"]),
        "timer_report": timer.report(num_views=len(cfg.dataset.folders_order)).splitlines(),
        "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "host_syncs_per_frame": syncs / frames.shape[0],
        "confirmed_track_frames": sum(len(p) for p in multi_poses3d.values()),
        "annotations": len(annotations),
    }, (multi_poses3d, annotations)


def clip_split(torch, pipe, frames, **capacities):
    """ms of stage A (`process_clip_nn`) and of the whole `process_clip` on
    the first clip from a fresh tracker, with the tracker capacities
    replaced by `capacities` for the call."""
    import dataclasses

    tcfg = pipe.tracker_cfg
    used = dataclasses.replace(tcfg, **capacities)
    clip = torch.as_tensor(frames[:CLI_CLIP]).cuda()
    try:
        pipe.tracker_cfg = used
        pipe.track_restart()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_clip_nn(clip)
        torch.cuda.synchronize()
        stage_a = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        pipe.process_clip(list(range(CLI_CLIP)), clip)
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) * 1e3
    finally:
        pipe.tracker_cfg = tcfg
        pipe.track_restart()
    return {"stage_a_ms": stage_a, "clip_ms": whole, "max_dets": used.max_dets,
            "max_tracks": used.max_tracks, "max_hyp": used.max_hyp}


def check_first_clip(torch, pipe, frames, multi_poses3d):
    """The loop's harvested poses and track ids for the first clip against
    `process_clip` + `harvest` on the same frames from a fresh tracker."""
    pipe.track_restart()
    outs, _, _ = pipe.process_clip(list(range(CLI_CLIP)), torch.as_tensor(frames[:CLI_CLIP]))
    worst, ids = 0.0, 0
    for t in range(CLI_CLIP):
        pts3d, tids, _ = pipe.harvest(type(outs)(*(x[t] for x in outs)), t)
        loop_pts = multi_poses3d[t]
        if pts3d.shape != loop_pts.shape:
            fail(f"CLI frame {t}: {loop_pts.shape} poses against process_clip's {pts3d.shape}")
        if pts3d.size:
            err = float(abs(pts3d - loop_pts).max())
            if not err <= 1e-3:
                fail(f"CLI frame {t}: poses differ from process_clip by {err}")
            worst = max(worst, err)
        ids += len(tids)
    return {"frames": CLI_CLIP, "pose_max_abs_diff": worst, "track_frames": ids}


def check_artifacts(cfg, multi_poses3d, annotations, scene):
    """Write the pkl and the per-camera JSONs, load them back, and score
    PCP against the scene's ground truth."""
    import pickle

    from tpupose_torch.cli.common import result_path
    from tpupose_torch.eval import (
        coco2shelf3d,
        evaluate_pcp,
        write_2d_result,
        write_3d_result,
    )

    pkl = result_path(cfg)
    write_3d_result(multi_poses3d, pkl)
    track_dir = os.path.join(cfg.output, cfg.dataset.test_dataset, "TrackResult")
    write_2d_result((CLI_HEIGHT, CLI_WIDTH), annotations, save_dir=track_dir)
    with open(pkl, "rb") as f:
        back = pickle.load(f)
    if sorted(back) != sorted(multi_poses3d):
        fail("the predictions pkl does not hold every frame")
    cameras = sorted({ann["cid"] for ann in annotations})
    for c in cameras:
        with open(os.path.join(track_dir, f"Camera{c}.json")) as f:
            entry = json.load(f)
        if entry["image_wh"] != [CLI_WIDTH, CLI_HEIGHT]:
            fail(f"Camera{c}.json: image_wh {entry['image_wh']}")
    actors_gt = [[coco2shelf3d(scene.gt3d[t, a].T) for t in range(scene.num_frames)]
                 for a in range(scene.num_actors)]
    res = evaluate_pcp([[0, scene.num_frames]], multi_poses3d, actors_gt)
    return {"pkl_frames": len(back), "camera_jsons": len(cameras),
            "average_pcp": res["average"]}


def phase_cli_path(torch, card):
    """Phase 10: the evaluation CLI's loop at full width from checkpoint
    files, in bf16 and then int8."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    import numpy as np

    from tpupose_torch.cli import common as cli
    from tpupose_torch.data.config import config_from_raw
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2

    counters = [(th, "launches"), (k2, "launches"), (k2, "quantize_launches")]
    out = {"card": card, "config": "configs/Shelf/model_configs.yaml with MAX_CANDIDATES 4: "
           "YOLOv3-416 + HRNet-W48 384x288 from .weights / .pth, BN folded, bf16; "
           f"{CLI_FRAMES} frames x 5 views x {CLI_HEIGHT}x{CLI_WIDTH} uint8, --clip {CLI_CLIP}"}
    with tempfile.TemporaryDirectory() as root:
        probe = config_from_raw(shelf_config(root, "", ""))
        det_cfg, pose_cfg = cli.yolo_config_from(probe), cli.hrnet_config_from(probe)
        t0 = time.perf_counter()
        weights, checkpoint, detector, pose = write_checkpoints(torch, root, det_cfg, pose_cfg)
        out["write_s"] = time.perf_counter() - t0
        out["file_mb"] = {"weights": os.path.getsize(weights) / 1e6,
                          "pth": os.path.getsize(checkpoint) / 1e6}
        cfg = config_from_raw(shelf_config(root, weights, checkpoint))
        views = len(cfg.dataset.folders_order)
        scene = make_scene(num_frames=CLI_FRAMES, num_cameras=views, num_actors=3, seed=0)
        t0 = time.perf_counter()
        pipe = cli.build_pipeline_real(cfg, {"P": scene.P, "K": scene.K, "RT": scene.RT},
                                       CLI_WIDTH, CLI_HEIGHT)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["tensors_equal"] = (
            check_state_dicts_equal(torch, pipe.detector,
                                    fold_batchnorm(detector, dtype=torch.bfloat16), "YOLOv3")
            + check_state_dicts_equal(torch, pipe.pose_model,
                                      fold_batchnorm(pose, dtype=torch.bfloat16), "HRNet"))
        del detector, pose
        gen = torch.Generator(device="cuda").manual_seed(10)
        frames = torch.randint(0, 256, (CLI_FRAMES, views, CLI_HEIGHT, CLI_WIDTH, 3),
                               generator=gen, device="cuda", dtype=torch.uint8).cpu().numpy()
        n_clips, n_tail = divmod(CLI_FRAMES, CLI_CLIP)
        for mode in ("bf16", "int8"):
            if mode == "int8":
                log = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with redirect_stdout(log):
                    # as evalmodel --int8: all views of the first frames;
                    # random weights drift by design, so report, do not gate
                    pipe.quantize_models(np.concatenate(frames[:CLI_CALIB], axis=0),
                                         on_drift="warn")
                torch.cuda.synchronize()
                out["quantize_s"] = time.perf_counter() - t0
                out["self_check"] = {"printed": log.getvalue().strip().splitlines(),
                                     **pipe.last_quant_report}
            run, (multi_poses3d, annotations) = cli_loop(torch, cfg, pipe, frames, card,
                                                         counters)
            expect = {k: (n_clips + n_tail) * v for k, v in STEP_LAUNCHES[mode].items()}
            if run["launches"] != expect:
                fail(f"CLI loop ({mode}) launched {run['launches']}, expected {expect}")
            run["first_clip_vs_process_clip"] = check_first_clip(torch, pipe, frames,
                                                                 multi_poses3d)
            # the config's tracker capacities against phase 5's
            run["split"] = [clip_split(torch, pipe, frames),
                            clip_split(torch, pipe, frames, max_dets=4, max_tracks=12,
                                       max_hyp=24)]
            run["artifacts"] = check_artifacts(cfg, multi_poses3d, annotations, scene)
            out[mode] = run
        del pipe, frames
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False", 2)
    sys.path.insert(0, ROOT)
    try:
        from tpupose_torch import kernels
        from tpupose_torch.ops import heatmap as th
    except ImportError as e:
        fail(f"the tpupose_torch package is not next to this script ({e})", 3)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    compiled = kernels.build_all(verbose=True)
    emit("build", seconds=time.perf_counter() - t0, compiled=compiled,
         kernels=sorted(kernels.sources()))

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = phase_kernel(th, torch, gen)
    emit("k1_vs_plain", card=card, **k1)

    k2 = phase_k2(torch, gen, card)
    emit("k2_vs_plain", **k2)

    main_path, state = phase_main_path(torch, gen, card)
    emit("main_path", **main_path)

    int8 = phase_int8_path(torch, card, state)
    emit("int8_main_path", **int8)
    pipe, clip, frame_ids = state[:3]

    emit("int8_resident", **phase_resident(torch, card, pipe, clip))
    emit("staged_api", **phase_staged(torch, card, pipe, clip, frame_ids))
    del pipe, clip, state

    tracker = phase_tracker(torch, card)
    emit("tracker_scene", **tracker)

    cli_path = phase_cli_path(torch, card)
    emit("cli_path", **cli_path)
    cli_launches = {mode: cli_path[mode]["launches"] for mode in ("bf16", "int8")}

    quarter = k1["modes"]["quarter"]
    conv = k2["timed"]["hrnet_branch0_3x3_48"]
    print(json.dumps({"kernels": [{
        "name": "heatmap_decode", "route": "cuda",
        "source": "tpupose_torch/csrc/heatmap_decode.cu",
        "replaces": "tpupose/ops/pallas_heatmap.py:69",
        "launches": int8["k1_launches"],
        "max_abs_err": k1["max_abs_err"], "ms": quarter["ms"],
        "plain_ms": quarter["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "cli_launches": {m: c["heatmap.launches"] for m, c in cli_launches.items()},
    }, {
        "name": "int8_conv", "route": "cuda",
        "source": "tpupose_torch/csrc/int8_conv.cu",
        "replaces": "tpupose/models/quantize.py:210",
        "launches": int8["k2_launches"],
        "max_abs_err": k2["max_abs_err"], "ms": conv["ms"],
        "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
        "bound_by": conv["bound_by"], "library_ms": None,
        "k2b_ms": conv["k2b"]["ms"], "design_bound_ms": conv["design_bound_ms"],
        "bf16_cudnn_ms": conv["bf16_cudnn_ms"], "shape": conv["shape"],
        "cli_launches": {m: c["int8_conv.launches"] for m, c in cli_launches.items()},
    }, {
        "name": "quantize_nhwc", "route": "cuda",
        "source": "tpupose_torch/csrc/int8_conv.cu",
        "replaces": "tpupose/models/quantize.py:229",
        "launches": int8["quantize_launches"],
        "max_abs_err": k2["k2a"]["max_abs_err"], "ms": conv["k2a"]["ms"],
        "plain_ms": conv["k2a"]["plain_ms"], "bound_ms": conv["k2a"]["bound_ms"],
        "bound_by": conv["k2a"]["bound_by"], "library_ms": None,
        "shape": conv["shape"][:4],
        "cli_launches": {m: c["int8_conv.quantize_launches"] for m, c in cli_launches.items()},
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
