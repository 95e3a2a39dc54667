#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`tpupose_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --learned-seeds 0 1 2   # phase 13 (e) per seed, no gates
    python3 chip_smoke.py --only k2 k3            # phases 4 and 15 (a) alone

Phases, in order (but 11 and 15 run after 8, so that phase 10's peak
memory holds none of phase 5's models, and 16 in two parts, (c) after 8
and (a), (b) inside 10); the first that fails ends the run
with a non-zero exit. "Host syncs" are the host's waits on the card inside
the pipeline's calls, counted under torch.cuda.set_sync_debug_mode("warn")
(`counted_syncs`); K3 launches are counted where the tracker runs:
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
     K2 (K2a + the implicit GEMM K2b, or the stem kernel for the stems'
     Cin of 3) runs on the whole batch, and its first and last 8 crops / 4
     images are held against the plain version on those images (the last
     ones sit at the largest offsets), the stems' whole outputs, 64 images
     a part; the stem kernel also at five small Cin-3 convs held whole
     (Cout 2, 8, 24, 40, 56, a W of 70, strides 1 and 2); then the times of K2, K2a and K2b alone, the plain version and
     the bf16 cuDNN conv, all on the whole batch, for HRNet branch 0's 3x3
     48->48 at 96x72 (x640) and YOLO's 3x3 128->256 at 52x52 (x160), and of
     the stem kernel, the gather kernel (the stems' route before), the
     plain version and cuDNN at HRNet's stem 3x3 s2 3->64 at 384x288 (x640)
     and YOLO's 3x3 3->32 at 416x416 (x160), each with its bound; K2a and
     K2 also at width-packed branch 0 (`ops.packing`: 3x3 96->96 at 96x36,
     x640, K = 864), checked as the main path's shapes and timed beside
     the unpacked branch 0, with the bf16 cuDNN conv's bound;
  5. the main path at full width in bf16: `Pipeline.process_clip` with
     YOLOv3-416 (max_candidates=4) and HRNet-W48 384x288, random weights
     from a seed, BN folded into bf16 weights, 32-frame clips of 5 views of
     720x1280 uint8 frames; the decode launch count, K3's (one association
     and one init LAP a camera, a frame), the stage A / stage B split, peak
     memory, host syncs;
  6. the int8 main path: `Pipeline.quantize_models` on 8 frames of one view
     (on_drift="warn": random weights drift by design, so the self-check
     report is printed and not gated on), then `process_clip` twice on the
     same clip; K1, K2, K2a and stem-kernel launch counts (364 K2, 362 K2a
     and 2 stem per clip expected), stage A, peak memory, and the
     int8-vs-bf16 keypoint shift
     (for information);
  7. int8-resident blocks: one HRNet-W48 forward with `int8_resident=True`
     on 8 crops in f32, each block held against the generic int8 block on
     the same input within the bound of the JAX package's test;
  8. the staged API: `process_frame` over the first 4 frames against
     `process_clip` on those frames (equal masks, detections within atol
     2e-2 / rtol 1e-3);
  9. the tracker on a synthetic scene with 5 views and 3 people: the same
     detections replayed through `person_track` on the card and on the CPU
     must give the same track ids, and 3 confirmed tracks; ms per frame, K3
     launches and host syncs (the host detections' copies) per frame;
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
     0 in bf16; 6, 6 x 364, 6 x 362 in int8) and K3 (68 x 6); each run's
     first clip
     against `process_clip` + `harvest` (poses within 1e-3), the pkl and
     per-camera JSONs written and read back, PCP scored against the
     scene's ground truth; times per clip and per trailing frame, the
     StageTimer report, peak memory;
 11. int8 with distill-QAT (`int8_qat`): phase 5's float models and phase
     6's 8 calibration frames. First `quantize_models` with the default
     on_drift="escalate" and QAT_ESCALATE_STEPS: random weights fail the
     self-check, escalate to distill-QAT, fail again and must raise
     QuantizationDriftError "after distill-QAT"; then `quantize_models`
     with qat_steps=QAT_STEPS and on_drift="warn": ms per QAT step per
     model, peak memory, first and last logged loss, the post-QAT
     self-check; then one int8 `process_clip` (1 K1, 364 K2, 362 K2a
     launches). Last, on the tiny configs in f32: the first QAT step's
     gradients of every fake-quant conv, card against CPU at the same
     input and output gradient, by relative norm (QAT_GRAD_LIMITS); then
     `distill_qat` for 3 steps on the card and on the CPU from the same
     weights and batches, held within Adam's bound (each step moves an
     entry by at most about lr), a sanity check;
 12. the CLI loop with tracks (`cli_tracks`): `run_eval_loop` fed the
     synthetic scene's detections (`synthetic_frame_source`, the
     `person_track` path) with Shelf's config's tracker capacities (16 /
     16 / 40), on the card and on the CPU: equal track ids and
     byte-equal per-camera JSONs, and confirmed tracks; ms per frame, host
     syncs and K3 launches per frame on the card.
 13. training (`train`) at full width: HRNet-W48 384x288 from a seed on blob
     batches of 8 (`models.train`): (a) `make_train_step` with
     `make_optimizer()` in bf16, inference-mode BN, 20 steps on one batch
     (ms per step, the median of steps 5-20, peak memory; the last loss
     must be below the first); (d) at step 10 the model and the optimizer
     are saved (`models.checkpoint`) and restored into fresh objects,
     every tensor torch.equal, and one more step from each (cuDNN
     deterministic) compared by gradient; (b) the JAX package's learning
     recipe, Adam 1e-3 in f32 with train-mode BN and a fresh batch per
     step, 20 steps (ms per step, peak memory, 4,000 steps extrapolated),
     then 6 steps with TF32 on; (c) on the tiny config, the first step's
     gradients of every trained tensor, BN statistics included, card
     against CPU in both BN modes (TRAIN_GRAD_LIMITS); (e) the tiny HRNet
     (weights from LEARN_SEED) trained on the card for 2,000 steps to
     localize blobs with cuDNN deterministic, folded and decoded with K1
     (< 25 px and < half its untrained error), then quantized within 2 px
     of it, every K2 call of that decode held torch.equal to the plain
     version on its own input;
 14. the end-to-end PCP chain (`e2e`, `eval.e2e`): phase 13 (b)'s W48 with
     its BN statistics re-estimated on its batch and folded to bf16, the
     crops of a 20-frame, 5-view, 2-actor scene (200 at 384x288),
     `decode_tree` with K1 counted from 0 (13 launches, each batch held
     against the plain decode of its heatmaps), `pcp_through_tracker` with
     perfect detections on the card and the CPU (the same table, PCP >=
     99), then the W48's and the learned tiny model's (bf16 and int8)
     decoded keypoints through the same chain, reported, with every K2
     call of the int8 decode held torch.equal to the plain version;
     stage B seconds;
 15. the multi-stream path (`multistream`, `tpupose_torch.parallel`), with
     the tracker at 4 / 12 / 24 and at 16 / 16 / 40: (a) K3, the batched
     masked LAP, torch.equal to its plain version on a CPU copy of the same
     inputs at the tracker's shapes (association: 5 x S problems of
     (max_tracks, max_dets), maximizing; init: S of (max_hyp, max_dets),
     solved transposed) for S in 1, 2, 8, 32, on uniform and on integer
     costs in [0, 3] (ties), and, where maximizing, on uniform scores with
     about half of them 0 (negated into -0.0), with random masks, an empty
     problem and one with no valid column, and 8 problems of (6, 100) and of
     (256, 9) (the kernel's wider variants); at each shape K3's `us` (median
     of 20 CUDA-event timings of one call on an idle card, the host's
     submission included), `host_us` (1,000 calls on the host clock while
     the card sleeps) and `device_us` (20 back-to-back calls behind a sleep
     longer than their submission, median of 5 runs), the same for an empty
     kernel, `op_host_us` (as `host_us`, through the op the tracker calls),
     the plain version's time on the card (S <= 2), the Dijkstra
     steps of each problem (counted by the plain version), and the latency
     bound: the longest problem's steps times one minimal dependent step,
     timed on a one-warp microkernel; (c) S = 1, 8, 32 streams of different
     continuous adversarial scenes (seeds 1..S, 64 frames) through
     `multistream_step` under set_sync_debug_mode("error"), every stream's
     track ids, validity and views equal to its own single-stream
     `track_clip` on the card; ms per step and per stream-frame; (b)
     `track_clip` of the 256-frame stream of bench.py's stage B on the card
     with its inputs already there, under set_sync_debug_mode("error"),
     against the CPU's run (made meanwhile in a worker process): equal track
     ids, validity and views, pose3d within 2e-2 m; stage B ms and K3
     launches per frame; (d) `make_multistream_clip_fn` at full width,
     bench.py's multistream leg: 2 streams of 128 frames of 5 random
     720x1280 views, YOLOv3-416 and HRNet-W48 folded to bf16, then int8
     through `quantize_convs` + `uncalibrated_scales`; fps, the stage A /
     stage B split (each alone to a sync), K1 / K2 / K2a / K3 launches
     counted from 0 (8, 0, 0, 768 in bf16; 8, 8 x 364, 8 x 362, 768 in
     int8), peak memory, host syncs; each stream's stage B equal to
     `track_clip` on its own stage-A detections, and (bf16, information)
     the share of its masks equal to `process_clip_nn`'s on the same frames.
 16. serving bundles and packing (`bundle_pack`): (c), after phase 8:
     `Pipeline.pack_models` on phase 5's bf16 models and on phase 6's int8
     pipeline, `process_clip` on phase 5's clip before and after from a
     fresh tracker (int8: detections and FrameOutputs torch.equal, K2
     launches at the packed input 64 of 364; bf16: equal masks, and on 64
     random crops the packed HRNet's heatmaps within 1e-4 of the unpacked
     ones in f32 and within 2x bf16's own error of them in bf16, relative
     norms; the decoded keypoints' agreement reported), then
     stage A unpacked and packed in turns (U P P U U P), int8 with K2's
     time in each; (a) and (b), inside phase 10 on its files and frames:
     `cli.convert.convert_checkpoints` writes a bf16 bundle, then an int8
     one quantized on the 8 calibration frames with on_drift="warn";
     `build_pipeline_real(bundle=...)` serves each with the checkpoint
     converters replaced by a function that fails; every tensor torch.equal
     to phase 10's pipeline (folded, or quantized in process); the CLI loop
     over the 68 frames gives phase 10's stage A detections (torch.equal),
     poses, launch counts and byte-equal per-camera JSONs (on random
     weights the tracker may confirm no track: the poses and JSONs are then
     empty on both sides); convert and load seconds, bundle MB.
With `--learned-seeds`, it builds the kernels and runs only phase 13 (e)
for each seed given, reporting the errors without gating on them (the
K2-against-plain check still fails the run). With `--only k2 k3`, it builds
the kernels and runs only phase 4 (k2) and phase 15 (a) (k3).
It prints a JSON line per phase, then `{"kernels": [...]}` (with each
kernel's launches in phase 10 as `cli_launches`, in phase 15 (d) as
`multistream_launches`, K1's in phase 14 as `e2e_launches`, K2's and
K2a's in phase 13 (e) as `learned_int8_launches`, K2's in phase 16 (b)'s
bundle loop as `bundle_launches`; K2's `packed_branch0` holds phase 4's
times and bounds at the packed branch-0 shape beside the unpacked one's
and phase 16 (c)'s K2 launches at that shape a packed clip; the stem kernel's row
times HRNet's stem and, under `yolo_stem`, YOLO's; K3's `launches` are
phase 15 (d)'s int8 run's, and its times those of (a) at (d)'s
association shape, with `device_us`, `host_us` and `op_host_us`; its
`bound_ms` is the latency bound, `bound_by` "latency", and the
bytes-or-operations bound of the other rows stands beside it as
`rate_bound_ms`), the nvidia-smi line, and last `{"ok": true, "device": {...}}`. It needs a CUDA
card and the repository around it; without either it exits non-zero and
prints no result. The f32 comparisons run with TF32 off (so do phase 11's
f32 fake-quant convolutions and phase 13's f32 training, but for the
6 steps that say so).
"""
from __future__ import annotations

import contextlib
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
H100_BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
MAIN_CROPS, MAIN_IMAGES = 640, 160  # the main path's batches (HRNet, YOLO)
SUB_CROPS, SUB_IMAGES = 8, 4     # images of a K2 output held against plain
STEM_PART = 64  # the stems' outputs are held against plain whole, 64 images a part
#: Stem-kernel convs off the main path, held whole against plain in phase 4:
#: Cout not a multiple of 16 (the tiny YOLO config's stem has Cout 2), and a
#: W that takes the scalar loads and stores, with tiles of several rows.
STEM_EDGE_SHAPES = ((3, 96, 128, 2, 3, 1, 1), (3, 96, 128, 40, 3, 2, 1),
                    (3, 50, 70, 8, 3, 1, 1), (3, 50, 70, 24, 3, 2, 1),
                    (3, 64, 96, 56, 3, 1, 1))
STEM_EDGE_BATCH = 4
#: HRNet-W48's branch-0 3x3 conv, 48->48 at 96x72, and its width-packed
#: form (`ops.packing`): 96->96 at 96x36, K = 864 (phase 4, phase 16 (c)).
BRANCH0 = (48, 96, 72, 48, 3, 1, 1)
BRANCH0_PACKED = (96, 96, 36, 96, 3, 1, 1)

#: configs/Shelf/model_configs.yaml as yaml.safe_load reads it, but with
#: the bench's MAX_CANDIDATES of 4 (bench.py:95-110), so that the CLI's
#: stage A has phase 5's size. Phase 10 also points WEIGHT, CHECKPOINT_FILE,
#: ROOT and OUTPUT at its temporary files (`shelf_config`). Written out here
#: so that the script needs no YAML reader (PyYAML is optional for the port).
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


@contextlib.contextmanager
def counted_syncs():
    """Counts the host waits on the card inside the block: with
    torch.cuda.set_sync_debug_mode("warn") every synchronizing call (a
    device -> host read, a blocking copy, a synchronize) warns once. Yields
    a dict whose "syncs" is set when the block ends."""
    import warnings

    import torch

    counter = {"syncs": 0}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield counter
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counter["syncs"] = sum("synchroniz" in str(w.message) for w in caught)


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


def k2_operands(torch, k2, gen, shape, batch, in_dtype, out_dtype, gain=40.0):
    """Random operands of one K2 call: weights, input, 1/x_scale and the
    epilogue vectors, scaled so that int8 outputs spread over [0, 127] (their
    standard deviation `gain` times 0.5-1.5 a channel). A float input holds
    a NaN in its first and its last image (quantized to 0, as XLA converts
    NaN to int8)."""
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
        mul, add = rnd * (gain / acc_std), torch.randn((cout,), generator=gen, device="cuda") * 10
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
    batch (and at packed branch 0's): bf16 and int8 inputs, and f32 at
    branch 0's input, packed and not."""
    from tpupose_torch.ops import int8_conv as k2

    inv = torch.tensor([127.0 / 8.0], device="cuda")
    inputs = sorted({(sh[:3], MAIN_CROPS) for sh in hr_shapes}
                    | {(BRANCH0_PACKED[:3], MAIN_CROPS)}
                    | {(sh[:3], MAIN_IMAGES) for sh in yo_shapes})
    checked = 0
    for shape, batch in inputs:
        dtypes = [torch.bfloat16, torch.int8]
        if shape in (BRANCH0[:3], BRANCH0_PACKED[:3]):
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
    if k2.stem_path(cin, k, k):  # the stems' route before the stem kernel
        out["gather_ms"] = cuda_time_ms(lambda: k2.gather_conv_cuda(
            x, wk, (k, k), inv, mul, add, b16, stride, dil), reps=10)
    if with_plain:
        out["plain_ms"] = cuda_time_ms(
            lambda: k2.int8_conv_plain(x, wq, inv, mul, add, b16, stride, dil),
            warmup=1, reps=3)
    wb = torch.randn((cout, cin, k, k), generator=gen, device="cuda").to(b16)
    out["bf16_cudnn_ms"] = cuda_time_ms(
        lambda: F.conv2d(x, wb, stride=stride, padding=k // 2, dilation=dil), reps=10)
    out["bf16_cudnn_bound"] = bound(x.numel() * 2 + wb.numel() * 2 + y.numel() * 2, ops,
                                    H100_BF16_OPS_PER_S)
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
    cases = ([(sh, MAIN_CROPS, SUB_CROPS, modes, 40.0)
              for sh in sorted(hr_shapes) + [BRANCH0_PACKED]]
             + [(sh, MAIN_IMAGES, SUB_IMAGES, modes, 40.0) for sh in sorted(yo_shapes)]
             + [(dilated, MAIN_CROPS, SUB_CROPS, modes + [(f32, f32), (f32, i8)], 40.0)]
             # few outputs a channel: a wider spread, so that requant-relu
             # still reaches both of its clamps
             + [(sh, STEM_EDGE_BATCH, STEM_EDGE_BATCH, modes + [(f32, f32), (f32, i8)],
                 120.0) for sh in STEM_EDGE_SHAPES])
    checked, stems, gathered, max_err, stem_err = 0, 0, 0, 0.0, 0.0
    for shape, batch, sub, shape_modes, gain in cases:
        cin, _, _, _, k, stride, dil = shape
        stem = k2.stem_path(cin, k, k)
        # the stems' outputs whole, the others' first and last images
        parts = ([(first, min(STEM_PART, batch - first)) for first in range(0, batch, STEM_PART)]
                 if stem else [(0, sub), (batch - sub, sub)])
        for in_dtype, out_dtype in shape_modes:
            wq, wk, x, inv, mul, add = k2_operands(torch, k2, gen, shape, batch, in_dtype,
                                                   out_dtype, gain)
            got = k2.int8_conv_cuda(x, wk, (k, k), inv, mul, add, out_dtype, stride, dil)
            what = f"K2 {shape} batch {batch} {in_dtype} -> {out_dtype}"
            if out_dtype != i8 and not bool(torch.isfinite(got).all()):
                fail(f"{what}: non-finite outputs")
            for first, size in parts:
                part = slice(first, first + size)
                ref = k2.int8_conv_plain(x[part], wq, inv, mul, add, out_dtype, stride, dil)
                err = float((got[part].float() - ref.float()).abs().max())
                max_err = max(max_err, err)
                if stem:
                    stem_err = max(stem_err, err)
                if not torch.equal(got[part], ref):
                    fail(f"{what}: images {first}..{first + size - 1} differ from the "
                         f"plain version by up to {err}")
                if out_dtype == i8 and not (ref.min() == 0 and ref.max() == 127):
                    fail(f"{what}: the requant check does not span [0, 127]")
                del ref
            checked += 1
            stems += stem
            gathered += not (stem or k2.channels_last(cin))
            del x, got
    timed = {name: time_k2(torch, gen, shape, batch, with_plain)
             for name, shape, batch, with_plain in (
                 ("hrnet_branch0_3x3_48", BRANCH0, MAIN_CROPS, True),
                 ("hrnet_branch0_packed_3x3_96", BRANCH0_PACKED, MAIN_CROPS, True),
                 ("yolo_3x3_128_256", (128, 52, 52, 256, 3, 1, 1), MAIN_IMAGES, True),
                 ("hrnet_stem_3x3_s2_3_64", (3, 384, 288, 64, 3, 2, 1), MAIN_CROPS, True),
                 ("yolo_stem_3x3_3_32", (3, 416, 416, 32, 3, 1, 1), MAIN_IMAGES, True))}
    return {"card": card, "checked": checked, "checked_on_stem_kernel": stems,
            "checked_on_gather_path": gathered, "stem_max_abs_err": stem_err,
            "k2a": k2a, "batch": {"hrnet_w48": MAIN_CROPS, "yolov3_416": MAIN_IMAGES},
            "compared_images": {"hrnet_w48": 2 * SUB_CROPS, "yolov3_416": 2 * SUB_IMAGES,
                                "stems": "all"},
            "distinct_shapes": {
                "hrnet_w48": len(hr_shapes), "yolov3_416": len(yo_shapes), "dilated": 1,
                "hrnet_w48_packed_branch0": 1},
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
    lap.launches = 0
    clip_ms, syncs = [], 0
    for _ in range(2):
        t0 = time.perf_counter()
        with counted_syncs() as counted:
            outs, dets, mask = pipe.process_clip(frame_ids, clip)
        torch.cuda.synchronize()
        clip_ms.append((time.perf_counter() - t0) * 1e3)
        syncs += counted["syncs"]
    launches, k3_launches = th.launches, lap.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches < 1:
        fail("the main path never launched the heatmap decode kernel")
    if k3_launches != 2 * frames * (1 + views):
        fail(f"two clips launched K3 {k3_launches} times, expected "
             f"{2 * frames * (1 + views)} (one association and {views} init LAPs a frame)")

    check_clip_outputs(torch, outs, dets, mask, frames, views, tcfg)
    ms = statistics.median(clip_ms)
    return {
        "config": "YOLOv3-416 (max_candidates=4) + HRNet-W48 384x288, BN folded, "
                  "bf16; 32 frames x 5 views x 720x1280 uint8",
        "card": card, "first_clip_s": first_s, "clip_ms": clip_ms,
        "ms_per_clip": ms, "fps": frames * 1e3 / ms,
        "stage_a_ms": stage_a_ms, "stage_b_ms": stage_b_ms,
        "stage_b_ms_per_frame": stage_b_ms / frames,
        "decode_launches": launches, "k3_launches": k3_launches, "clips": 2,
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
    k2.stem_launches = 0
    lap.launches = 0
    clip_ms, syncs = [], 0
    for _ in range(2):
        t0 = time.perf_counter()
        with counted_syncs() as counted:
            outs, dets, mask = pipe.process_clip(frame_ids, clip)
        torch.cuda.synchronize()
        clip_ms.append((time.perf_counter() - t0) * 1e3)
        syncs += counted["syncs"]
    k1_launches, k2_launches, k3_launches = th.launches, k2.launches, lap.launches
    k2a_launches, stem_launches = k2.quantize_launches, k2.stem_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if k1_launches < 1 or (k2_launches, k2a_launches, stem_launches) != (2 * 364, 2 * 362, 2 * 2):
        fail(f"two int8 clips launched K1 {k1_launches}, K2 {k2_launches}, K2a "
             f"{k2a_launches} and the stem kernel {stem_launches} times, expected >= 1, "
             f"728, 724 and 4")
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
        "stem_launches": stem_launches,
        "k1_launches": k1_launches, "k3_launches": k3_launches, "clips": 2,
        "k2_ms_in_stage_a": k2_ms, "k2_calls_timed": k2_calls,
        "host_syncs_per_frame": syncs / (2 * frames),
        "detections_valid": int(mask.sum()), "masks_equal_bf16": bool(torch.equal(mask, mask_bf16)),
        "kps_shift_vs_bf16_px": {"median": float(shift.median()), "p95": float(shift.quantile(0.95)),
                                 "max": float(shift.max()), "n": int(shift.numel())},
        "peak_mem_gib": peak_gib,
    }


def k2_time_in_stage_a(torch, pipe, clip, shape=None):
    """Summed device time of the K2 launches in one int8 stage A, by CUDA
    events around each launch (after the counted runs; no host syncs), and
    the number of launches; with `shape`, a (C, H, W) input, also the
    number of launches at it."""
    from tpupose_torch.ops import int8_conv as k2

    events, inner, at_shape = [], k2.int8_conv_cuda, [0]

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = inner(*args, **kw)
        end.record()
        events.append((start, end))
        at_shape[0] += tuple(args[0].shape[1:]) == shape
        return y

    k2.int8_conv_cuda = timed
    try:
        pipe.process_clip_nn(clip)
    finally:
        k2.int8_conv_cuda = inner
    torch.cuda.synchronize()
    if shape is None:
        return sum(s.elapsed_time(e) for s, e in events), len(events)
    return sum(s.elapsed_time(e) for s, e in events), len(events), at_shape[0]


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


PACK_TIMED_ORDER = "UPPUUP"  # phase 16 (c): stage A unpacked (U) and packed (P) in turns
PACK_CROPS = 64  # random crops for phase 16 (c)'s heatmap check
#: Phase 16 (c), bf16: packing may change the heatmaps by at most this
#: multiple of bf16's own error (bf16 against f32 on the same weights, in
#: relative norm): two independent bf16 roundings differ by about sqrt(2)
#: times one. In f32 (TF32 off) the packed net is held within this
#: relative norm of the unpacked one, the CPU tests' 1e-4.
PACK_BF16_ERR_MULT, PACK_F32_REL = 2.0, 1e-4


def packed_heatmaps(torch, unpacked, packed):
    """Heatmaps of the unpacked and packed HRNet on the same random crops,
    in bf16 and in f32 (copies of the bf16 weights cast to f32): relative
    norms of packed against unpacked and of bf16 against f32, and the share
    of planes whose argmax agrees packed and unpacked in bf16."""
    import copy

    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((PACK_CROPS, 3, *unpacked.cfg.input_size), generator=gen, device="cuda")

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    with torch.inference_mode():
        hu, hp = unpacked(x, torch.bfloat16), packed(x, torch.bfloat16)
        hu32 = copy.deepcopy(unpacked).float()(x, torch.float32)
        hp32 = copy.deepcopy(packed).float()(x, torch.float32)
    argmax_equal = (hu.flatten(2).argmax(-1) == hp.flatten(2).argmax(-1)).float().mean()
    return {"crops": PACK_CROPS, "bf16_packed_vs_unpacked": rel(hp, hu),
            "bf16_vs_f32": rel(hu, hu32), "f32_packed_vs_unpacked": rel(hp32, hu32),
            "bf16_argmax_equal_share": float(argmax_equal)}


def pack_one(torch, pipe, clip, frame_ids, mode):
    """Phase 16 (c) for one pipeline: `process_clip` before and after
    `Pipeline.pack_models` from a fresh tracker, the packed clip's K1 / K2
    / K2a / stem launches counted from 0, then stage A (`process_clip_nn`,
    to a sync) unpacked and packed in turns; int8 also K2's summed time in
    each stage A. The pipeline is left unpacked."""
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2

    pipe.track_restart()
    outs_u, dets_u, mask_u = pipe.process_clip(frame_ids, clip)
    unpacked = (pipe.pose_cfg, pipe.pose_model)
    pipe.pack_models()
    packed = (pipe.pose_cfg, pipe.pose_model)
    if not packed[0].pack_branch0 or packed[1] is unpacked[1]:
        fail(f"pack_models ({mode}) did not swap in a packed pose model")
    pipe.track_restart()
    torch.cuda.synchronize()
    th.launches = k2.launches = k2.quantize_launches = k2.stem_launches = 0
    outs_p, dets_p, mask_p = pipe.process_clip(frame_ids, clip)
    torch.cuda.synchronize()
    launches = {"k1": th.launches, "k2": k2.launches, "k2a": k2.quantize_launches,
                "k2_stem": k2.stem_launches}
    expect = STEP_LAUNCHES[mode]
    if (launches["k1"], launches["k2"], launches["k2a"], launches["k2_stem"]) != (
            expect["heatmap.launches"], expect["int8_conv.launches"],
            expect["int8_conv.quantize_launches"], expect["int8_conv.stem_launches"]):
        fail(f"the packed {mode} clip launched {launches}, expected {expect}")
    if not torch.equal(mask_p, mask_u):
        fail(f"packed {mode} clip: detection masks differ from the unpacked clip")
    out = {"launches": launches, "masks_equal": True, "detections_valid": int(mask_u.sum())}
    err = (dets_p - dets_u).abs()[mask_u]
    close = err <= 2e-2 + 1e-3 * dets_u.abs()[mask_u]
    out["dets_max_abs_diff"] = float(err.max()) if err.numel() else 0.0
    out["share_within_2e-2"] = float(close.float().mean()) if err.numel() else 1.0
    if mode == "int8":
        # int32 sums are exact and the structural zeros add nothing
        if not torch.equal(dets_p, dets_u):
            fail(f"packed int8 clip: detections differ from the unpacked clip by up to "
                 f"{out['dets_max_abs_diff']}")
        for field in ("valid", "track_id", "pose3d"):
            if not torch.equal(getattr(outs_p, field), getattr(outs_u, field)):
                fail(f"packed int8 clip: FrameOutput.{field} differs from the unpacked clip")
        out["dets_equal"] = out["outputs_equal"] = True
    else:
        # cuDNN sums packed convs in another order: the decoded keypoints of
        # random weights' near-flat heatmaps flip their argmax (reported),
        # so the check is on the heatmaps
        heat = out["heatmaps"] = packed_heatmaps(torch, unpacked[1], packed[1])
        if heat["f32_packed_vs_unpacked"] > PACK_F32_REL:
            fail(f"packed HRNet in f32: relative difference {heat['f32_packed_vs_unpacked']} "
                 f"from the unpacked one, above {PACK_F32_REL}")
        if heat["bf16_packed_vs_unpacked"] > PACK_BF16_ERR_MULT * heat["bf16_vs_f32"]:
            fail(f"packed HRNet in bf16: relative difference {heat['bf16_packed_vs_unpacked']} "
                 f"from the unpacked one, above {PACK_BF16_ERR_MULT} x bf16's own "
                 f"{heat['bf16_vs_f32']}")

    times = {"U": [], "P": []}
    k2_ms = {}
    for which in PACK_TIMED_ORDER:
        pipe.pose_cfg, pipe.pose_model = unpacked if which == "U" else packed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_clip_nn(clip)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3)
    if mode == "int8":
        for which in "UP":
            pipe.pose_cfg, pipe.pose_model = unpacked if which == "U" else packed
            k2_ms[which], _, out[f"k2_launches_at_packed_shape_{which}"] = k2_time_in_stage_a(
                torch, pipe, clip, BRANCH0_PACKED[:3])
        cfg = unpacked[0]
        n_packed = 2 * cfg.stage_blocks * sum(cfg.stage_modules)  # conv1, conv2 a block
        if (out["k2_launches_at_packed_shape_U"], out["k2_launches_at_packed_shape_P"]) != (
                0, n_packed):
            fail(f"K2 launches at the packed branch-0 input: {out['k2_launches_at_packed_shape_U']}"
                 f" unpacked, {out['k2_launches_at_packed_shape_P']} packed, expected 0 and "
                 f"{n_packed}")
    pipe.pose_cfg, pipe.pose_model = unpacked
    out.update(stage_a_ms={"unpacked": times["U"], "packed": times["P"]},
               stage_a_median_ms={"unpacked": statistics.median(times["U"]),
                                  "packed": statistics.median(times["P"])})
    out["stage_a_ratio"] = out["stage_a_median_ms"]["packed"] / out["stage_a_median_ms"]["unpacked"]
    if k2_ms:
        out["k2_ms_in_stage_a"] = {"unpacked": k2_ms["U"], "packed": k2_ms["P"]}
    return out


def phase_pack(torch, card, int8_pipe, float_models, clip, frame_ids):
    """Phase 16 (c): `Pipeline.pack_models` on phase 5's bf16 models and on
    phase 6's int8 pipeline, on phase 5's clip (see `pack_one`)."""
    from tpupose_torch.pipeline import Pipeline

    int8 = pack_one(torch, int8_pipe, clip, frame_ids, "int8")
    return {"card": card, "int8": int8,
            "bf16": pack_one(torch, Pipeline(*float_models), clip, frame_ids, "bf16")}


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

    step_s, syncs, err = 0.0, 0, 0.0
    lap.launches = 0
    for t in range(frames):
        dets = torch.zeros((views, D, 17, 3))
        mask = torch.zeros((views, D), dtype=torch.bool)
        dets[:, :3] = torch.as_tensor(scene.detections[t])
        mask[:, :3] = torch.as_tensor(scene.visible[t])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # person_track takes host detections: their copy to the card waits
        with counted_syncs() as counted:
            out_g = gpu.person_track(t, dets, mask)
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t0
        syncs += counted["syncs"]
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
            "k3_launches_per_frame": lap.launches / frames,
            "host_syncs_per_frame": syncs / frames, "pose3d_max_abs_diff_m": err}


CLI_FRAMES, CLI_CLIP, CLI_CALIB = 68, 32, 8  # 2 clips + 4 trailing frames
CLI_HEIGHT, CLI_WIDTH = 720, 1280
#: K1, K2 and K2a launches per `process_clip` or `process_frame` call (one
#: stage A batch each): one decode, and in int8 the 364 quantized convs of
#: YOLOv3-416 and HRNet-W48, 362 of them through K2a and the 2 RGB stems
#: through the stem kernel (phase 6's counts).
STEP_LAUNCHES = {
    "bf16": {"heatmap.launches": 1, "int8_conv.launches": 0,
             "int8_conv.quantize_launches": 0, "int8_conv.stem_launches": 0},
    "int8": {"heatmap.launches": 1, "int8_conv.launches": 364,
             "int8_conv.quantize_launches": 362, "int8_conv.stem_launches": 2},
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
    returned = {"process_clip": [], "process_frame": []}  # host clock at return
    syncs = [0]
    detections = []  # (detections, mask) of each call, in order

    def timed(name):
        fn = getattr(pipe, name)

        def run(*args, **kw):
            t0 = time.perf_counter()
            with counted_syncs() as counted:
                out = fn(*args, **kw)
            returned[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            calls[name].append((time.perf_counter() - t0) * 1e3)
            syncs[0] += counted["syncs"]
            detections.append(out[1:])
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
    lap.launches = 0
    t0 = time.perf_counter()
    try:
        multi_poses3d, annotations = cli.run_eval_loop(cfg, pipe, source(), timer,
                                                       clip=CLI_CLIP)
        torch.cuda.synchronize()
    finally:
        del pipe.process_clip, pipe.process_frame
    loop_s = time.perf_counter() - t0
    launches = {f"{module.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(module, attr)
                for module, attr in counters}
    n_clips, n_tail = divmod(frames.shape[0], CLI_CLIP)
    if (len(calls["process_clip"]), len(calls["process_frame"])) != (n_clips, n_tail):
        fail(f"the CLI loop made {len(calls['process_clip'])} process_clip and "
             f"{len(calls['process_frame'])} process_frame calls, expected {n_clips} "
             f"and {n_tail}")
    if sorted(multi_poses3d) != list(range(frames.shape[0])):
        fail("the CLI loop did not harvest every frame")
    views = len(cfg.dataset.folders_order)
    if lap.launches != frames.shape[0] * (1 + views):
        fail(f"the CLI loop launched K3 {lap.launches} times, expected "
             f"{frames.shape[0] * (1 + views)}")
    return {
        "card": card, "loop_s": loop_s, "clip_ms": calls["process_clip"],
        "ms_per_clip": statistics.median(calls["process_clip"]),
        "clip_returned_ms": returned["process_clip"],
        "frame_ms": calls["process_frame"],
        "ms_per_trailing_frame": statistics.median(calls["process_frame"]),
        "timer_report": timer.report(num_views=len(cfg.dataset.folders_order)).splitlines(),
        "launches": launches, "k3_launches": lap.launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "host_syncs_per_frame": syncs[0] / frames.shape[0],
        "confirmed_track_frames": sum(len(p) for p in multi_poses3d.values()),
        "annotations": len(annotations),
    }, (multi_poses3d, annotations, detections)


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

    counters = [(th, "launches"), (k2, "launches"), (k2, "quantize_launches"),
                (k2, "stem_launches")]
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
        camera_parameter = {"P": scene.P, "K": scene.K, "RT": scene.RT}
        direct = {}  # each mode's served modules and loop outputs, for phase 16
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
            run, (multi_poses3d, annotations, detections) = cli_loop(torch, cfg, pipe, frames,
                                                                     card, counters)
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
            direct[mode] = {"detector": pipe.detector, "pose_model": pipe.pose_model,
                            "poses": multi_poses3d, "annotations": annotations,
                            "detections": detections}
        del pipe
        bundles = bundle_serving(torch, card, cfg, camera_parameter, frames, direct, counters)
        bundles["load_s_from_checkpoints"] = out["load_s"]
        del frames, direct
    return out, bundles


BUNDLE_CONVERTERS = ("load_darknet_weights", "read_darknet_file",
                     "darknet_array_to_state_dict", "load_hrnet_torch_checkpoint")


def json_bytes_equal(annotations, ref, root):
    """The per-camera JSONs `write_2d_result` writes for `annotations` and
    for `ref`, compared byte for byte; returns the number of files."""
    from tpupose_torch.eval import write_2d_result

    dirs = [os.path.join(root, name) for name in ("got", "ref")]
    for d, anns in zip(dirs, (annotations, ref)):
        write_2d_result((CLI_HEIGHT, CLI_WIDTH), anns, save_dir=d)
    names = sorted(os.listdir(dirs[1])) if os.path.isdir(dirs[1]) else []
    if (sorted(os.listdir(dirs[0])) if os.path.isdir(dirs[0]) else []) != names:
        fail("bundle: the per-camera JSON files differ from the direct run's")
    for name in names:
        with open(os.path.join(dirs[0], name), "rb") as a, open(os.path.join(dirs[1], name), "rb") as b:
            if a.read() != b.read():
                fail(f"bundle: {name} differs from the direct run's")
    return len(names)


def bundle_serving(torch, card, cfg, camera_parameter, frames, direct, counters):
    """Phase 16 (a) and (b): `cli.convert.convert_checkpoints` writes a bf16
    bundle and an int8 one (quantized on phase 10's 8 calibration frames,
    on_drift="warn") from phase 10's checkpoint files; `build_pipeline_real(
    bundle=...)` serves each with the checkpoint converters replaced by a
    function that fails; every tensor equals phase 10's directly loaded (or
    in-process quantized) models', and `run_eval_loop` over phase 10's
    frames gives its stage A detections (torch.equal, every call), poses
    and byte-equal per-camera JSONs, with phase 10's launch counts."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    import numpy as np

    from tpupose_torch.cli import common as cli
    from tpupose_torch.cli import convert
    from tpupose_torch.models import convert as mconv

    out = {"card": card}
    n_clips, n_tail = divmod(CLI_FRAMES, CLI_CLIP)
    calib = np.concatenate(frames[:CLI_CALIB], axis=0)
    for mode in ("bf16", "int8"):
        with tempfile.TemporaryDirectory() as root:
            bundle = os.path.join(root, f"bundle_{mode}")
            log = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with redirect_stdout(log):
                manifest, _, _ = convert.convert_checkpoints(
                    cfg, bundle, int8=mode == "int8", calib_images=calib,
                    camera_parameter=camera_parameter, on_drift="warn")
            torch.cuda.synchronize()
            run = {"convert_s": time.perf_counter() - t0,
                   "manifest": {k: manifest[k] for k in ("format", "folded", "dtype", "quantized")},
                   "bundle_mb": sum(os.path.getsize(os.path.join(bundle, f))
                                    for f in convert.BUNDLE_FILES.values()) / 1e6}
            if mode == "int8":
                run["self_check"] = log.getvalue().strip().splitlines()

            def refuse(*a, **k):
                raise AssertionError("a checkpoint converter ran on the bundle path")

            saved = {name: getattr(mconv, name) for name in BUNDLE_CONVERTERS}
            for name in saved:
                setattr(mconv, name, refuse)
            try:
                t0 = time.perf_counter()
                pipe = cli.build_pipeline_real(cfg, camera_parameter, CLI_WIDTH, CLI_HEIGHT,
                                               bundle=bundle)
                torch.cuda.synchronize()
                run["load_s"] = time.perf_counter() - t0
            finally:
                for name, fn in saved.items():
                    setattr(mconv, name, fn)
            ref = direct[mode]
            run["tensors_equal"] = (
                check_state_dicts_equal(torch, pipe.detector, ref["detector"], f"{mode} bundle YOLOv3")
                + check_state_dicts_equal(torch, pipe.pose_model, ref["pose_model"],
                                          f"{mode} bundle HRNet"))
            loop, (poses, annotations, detections) = cli_loop(torch, cfg, pipe, frames, card,
                                                              counters)
            expect = {k: (n_clips + n_tail) * v for k, v in STEP_LAUNCHES[mode].items()}
            if loop["launches"] != expect:
                fail(f"bundle CLI loop ({mode}) launched {loop['launches']}, expected {expect}")
            if len(detections) != len(ref["detections"]) or not all(
                    torch.equal(a, b) for got, want in zip(detections, ref["detections"])
                    for a, b in zip(got, want)):
                fail(f"bundle CLI loop ({mode}): stage A detections differ from the direct run's")
            if list(poses) != list(ref["poses"]):
                fail(f"bundle CLI loop ({mode}): other frames than the direct run's")
            for t, p in ref["poses"].items():
                if p.shape != poses[t].shape or not np.array_equal(p, poses[t]):
                    fail(f"bundle CLI loop ({mode}): frame {t}'s poses differ from the direct run's")
            run["camera_jsons_equal"] = json_bytes_equal(annotations, ref["annotations"], root)
            run.update(poses_equal=True, detections_equal=True,
                       detections_valid=sum(int(m.sum()) for _, m in detections),
                       track_frames=sum(len(p) for p in poses.values()),
                       loop={k: loop[k] for k in ("loop_s", "ms_per_clip", "ms_per_trailing_frame",
                                                  "launches", "k3_launches", "peak_mem_gib")})
            del pipe
        out[mode] = run
    return out


QAT_ESCALATE_STEPS, QAT_STEPS = 10, 20  # distill-QAT steps per model in phase 11
TINY_QAT_LR = 1e-5  # the JAX default learning rate


class QatLog:
    """`qat_log` for `quantize_models`: (step, loss, seconds after a device
    sync) per call; a step that does not grow starts the next model's run
    (the detector trains first, then the pose model)."""

    def __init__(self, torch):
        self.torch, self.runs = torch, []

    def __call__(self, step, loss):
        self.torch.cuda.synchronize()
        if not self.runs or step <= self.runs[-1][-1][0]:
            self.runs.append([])
        self.runs[-1].append((step, loss, time.perf_counter()))

    def summary(self):
        out = []
        for model, run in zip(("yolov3_416", "hrnet_w48"), self.runs):
            (s0, l0, t0), (s1, l1, t1) = run[0], run[-1]
            out.append({"model": model, "steps_logged": [s for s, _, _ in run],
                        "first_loss": l0, "last_loss": l1,
                        "ms_per_step": (t1 - t0) * 1e3 / (s1 - s0) if s1 > s0 else None})
        return out


def phase_int8_qat(torch, card, models, clip, frame_ids):
    """Phase 11: escalation to distill-QAT that must still refuse, then
    qat_steps with on_drift="warn", then one int8 clip; last the tiny-config
    card-vs-CPU check."""
    import io
    from contextlib import redirect_stdout

    from tpupose_torch.models.layers import QuantConv2d
    from tpupose_torch.models.quantize import QuantizationDriftError
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2
    from tpupose_torch.pipeline import Pipeline

    cams, tcfg, det_cfg, detector, pose_cfg, pose = models
    pipe = Pipeline(cams, tcfg, det_cfg, detector, pose_cfg, pose)
    calib = clip[:8, 0].contiguous()  # phase 6's calibration frames
    out = {"card": card, "precision": "bf16 networks, f32 fake-quant convs with TF32 off",
           "calibration_images": int(calib.shape[0])}

    log, qat_log = io.StringIO(), QatLog(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with redirect_stdout(log):
            pipe.quantize_models(calib, escalate_steps=QAT_ESCALATE_STEPS, qat_log=qat_log)
    except QuantizationDriftError as e:
        refused = str(e)
    else:
        fail("escalation to distill-QAT served random weights; expected a refusal")
    torch.cuda.synchronize()
    printed = log.getvalue().strip().splitlines()
    print("\n".join(printed + [refused]), flush=True)
    if "after distill-QAT" not in refused or not any(
            "escalating to label-free distill-QAT" in ln for ln in printed):
        fail(f"escalation: unexpected messages {printed} / {refused}")
    if isinstance(pipe.pose_model.layer1[0].conv1, QuantConv2d):
        fail("escalation: a refused int8 model was served")
    out["escalate"] = {"steps": QAT_ESCALATE_STEPS, "seconds": time.perf_counter() - t0,
                       "printed": printed, "refused": refused,
                       "after_qat": dict(pipe.last_quant_report), "qat": qat_log.summary()}

    log, qat_log = io.StringIO(), QatLog(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with redirect_stdout(log):
        pipe.quantize_models(calib, qat_steps=QAT_STEPS, on_drift="warn", qat_log=qat_log)
    torch.cuda.synchronize()
    printed = log.getvalue().strip().splitlines()
    print("\n".join(printed), flush=True)
    out["qat"] = {"steps": QAT_STEPS, "seconds": time.perf_counter() - t0, "printed": printed,
                  "self_check": dict(pipe.last_quant_report),
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "models": qat_log.summary(),
                  "extrapolated_900_steps_s": sum(
                      900 * m["ms_per_step"] / 1e3 for m in qat_log.summary())}

    pipe.track_restart()
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()
    th.launches = k2.launches = k2.quantize_launches = 0
    t0 = time.perf_counter()
    outs, dets, mask = pipe.process_clip(frame_ids, clip)
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t0) * 1e3
    launches = {"k1": th.launches, "k2": k2.launches, "k2a": k2.quantize_launches}
    if launches != {"k1": 1, "k2": 364, "k2a": 362}:
        fail(f"the int8 clip after distill-QAT launched {launches}, expected 1 / 364 / 362")
    check_clip_outputs(torch, outs, dets, mask, clip.shape[0], clip.shape[1], tcfg)
    out["clip"] = {"ms": clip_ms, "launches": launches, "detections_valid": int(mask.sum())}
    out["tiny_card_vs_cpu"] = tiny_qat_card_vs_cpu(torch)
    return out


#: worst-leaf relative norm of a fake-quant conv's first-step gradients,
#: card against CPU at the same input and output gradient (TF32 off): the
#: weight, bias and input gradients, and `fq_x_scale`'s LSQ gradient, which
#: sums terms of both signs over the whole input and so amplifies the f32
#: summation noise where they cancel. Set from readings on the H100 (PERF.md
#: section 6); tests/test_torch_qat.py holds the port against `jax.vjp` so.
QAT_GRAD_LIMITS = {"weight": 1e-5, "bias": 1e-5, "input": 1e-5, "fq_x_scale": 2e-2}


def first_step_taps(tq, fq, apply, x, target):
    """One backward of `distill_loss` through the fake-quant model `fq`:
    {conv: (its input, its output's gradient)} for every fake-quant conv;
    the parameters' `.grad` then hold the first QAT step's gradients."""
    from tpupose_torch.models.layers import FakeQuantConv2d

    taps = {}

    def hook(conv, inp, out):
        xin = inp[0].detach().clone()
        out.register_hook(lambda g: taps.__setitem__(conv, (xin, g.detach().clone())))

    handles = [m.register_forward_hook(hook) for m in fq.modules()
               if isinstance(m, FakeQuantConv2d)]
    try:
        tq.distill_loss(apply, fq, x, target).backward()
    finally:
        for h in handles:
            h.remove()
    return taps


def qat_first_gradients(torch, tq, name, folded, x, skip_fn):
    """The first QAT step's gradients, card against CPU, from one fake-quant
    start (calibrated on the CPU, copied to the card). Each fake-quant conv
    of the card's backward is recomputed on the CPU at the card's input and
    output gradient: weight, bias and `fq_x_scale` gradients (what Adam
    takes) and the input gradient (what flows on), each leaf by its
    relative norm, held to QAT_GRAD_LIMITS. The whole network's gradients
    (the CPU's own backward) are reported beside: an int8 code flip in one
    conv input (f32 summation order) spreads through a random-weight net."""
    import copy

    apply = lambda m, b: m(b, torch.float32)  # noqa: E731
    scales = tq.calibrate(lambda b: apply(folded, b), x)
    fq_cpu = tq.fake_quant_convs(folded, scales, skip_fn(folded))
    runs = {}
    for device in ("cuda", "cpu"):
        fq = copy.deepcopy(fq_cpu).to(device)
        xd = x.to(device)
        with torch.no_grad():
            target = [t.to(torch.float32)
                      for t in tq._as_list(apply(copy.deepcopy(folded).to(device), xd))]
        runs[device] = (fq, first_step_taps(tq, fq, apply, xd, target))
    (fq_card, taps), (fq_ref, _) = runs["cuda"], runs["cpu"]

    def rel(got, ref):
        got = got.detach().cpu()
        return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))

    worst = {leaf: 0.0 for leaf in QAT_GRAD_LIMITS}
    where = {}
    for conv_name, conv in fq_card.named_modules():
        if conv not in taps:
            continue
        xin, g = taps[conv]
        ref_conv = copy.deepcopy(fq_cpu.get_submodule(conv_name))
        xc = xin.cpu().requires_grad_(True)
        leaves = [("input", xc), ("weight", ref_conv.weight), ("fq_x_scale", ref_conv.fq_x_scale)]
        if ref_conv.bias is not None:
            leaves.append(("bias", ref_conv.bias))
        refs = torch.autograd.grad(tq.fake_quant_conv_apply(ref_conv, xc), [t for _, t in leaves],
                                   g.cpu())
        xg = xin.requires_grad_(True)
        (gx_card,) = torch.autograd.grad(tq.fake_quant_conv_apply(conv, xg), xg, g)
        got = {"input": gx_card, "weight": conv.weight.grad, "fq_x_scale": conv.fq_x_scale.grad,
               "bias": conv.bias.grad if conv.bias is not None else None}
        for (leaf, _), ref in zip(leaves, refs):
            err = rel(got[leaf], ref)
            if err >= worst[leaf]:
                worst[leaf], where[leaf] = err, conv_name
    if len(taps) < 30:
        fail(f"tiny {name} QAT: {len(taps)} fake-quant convs in the backward")
    whole = {}
    for pname, p in fq_card.named_parameters():
        whole[pname] = rel(p.grad, fq_ref.get_parameter(pname).grad)
    out = {"convs": len(taps), "worst_rel": worst, "worst_at": where,
           "limits": QAT_GRAD_LIMITS,
           "whole_net_median_rel": statistics.median(whole.values()),
           "whole_net_max_rel": max(whole.values())}
    for leaf, limit in QAT_GRAD_LIMITS.items():
        if not worst[leaf] <= limit:
            fail(f"tiny {name} QAT: first-step {leaf} gradient of {where[leaf]} differs card vs "
                 f"CPU by a relative norm of {worst[leaf]} > {limit} ({out})")
    return out


def tiny_qat_card_vs_cpu(torch):
    """The tiny HRNet / YOLO (BN statistics re-estimated, then folded) in
    f32: first the first QAT step's gradients card against CPU
    (`qat_first_gradients`), then `distill_qat`, 3 steps at TINY_QAT_LR, on
    the card and on the CPU from the same weights and batches.

    Bounds of the 3-step run, a sanity check: from one start, each Adam
    step moves an entry by at most about lr (the bias-corrected m / sqrt(v)
    is at most 1.0014 in the first three steps), so trained float entries
    stay within 6.1 lr of each other; activation scales within that plus
    rtol 1e-4 for their calibration; int8 weights at most 1 apart, in at
    most 1% of entries. An int8 code flip in one conv input (f32 summation
    order) spreads through a random net, so the trajectories part; the
    measured maxima are reported beside the bounds."""
    import copy

    from tpupose_torch.models import quantize as tq
    from tpupose_torch.models.hrnet import hrnet_init, tiny_test_config
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.models.yolov3 import tiny_yolo_test_config, yolov3_init

    gen = torch.Generator().manual_seed(11)
    lr, out = TINY_QAT_LR, {"lr": TINY_QAT_LR, "steps": 3}
    hr_cfg, yo_cfg = tiny_test_config(), tiny_yolo_test_config()
    cases = (
        ("hrnet", hrnet_init(hr_cfg, gen), torch.rand((4, 3, *hr_cfg.input_size), generator=gen),
         tq.hrnet_skip_ids),
        ("yolo", yolov3_init(yo_cfg, gen),
         torch.rand((4, 3, yo_cfg.input_size, yo_cfg.input_size), generator=gen),
         lambda m: tq.yolo_skip_ids(m, yo_cfg)))
    for name, raw, x, skip_fn in cases:
        tq.calibrate_bn_stats(lambda b: raw(b, torch.float32), x)
        folded = fold_batchnorm(raw)
        grads = qat_first_gradients(torch, tq, name, folded, x, skip_fn)
        runs = {}
        for device in ("cuda", "cpu"):
            model = copy.deepcopy(folded).to(device)
            losses = []
            q = tq.distill_qat(lambda m, b: m(b, torch.float32), model, [x.to(device)],
                               steps=3, lr=lr, skip_ids=skip_fn(model),
                               log=lambda i, v: losses.append(v))
            runs[device] = ({k: v.cpu() for k, v in q.state_dict().items()}, losses)
        (card, card_losses), (cpu, cpu_losses) = runs["cuda"], runs["cpu"]
        worst_w = worst_s = 0.0
        flips = total = 0
        for k, ref in cpu.items():
            got = card[k]
            if k.endswith("weight_q"):
                diff = (got.int() - ref.int()).abs()
                if int(diff.max()) > 1:
                    fail(f"tiny {name} QAT: {k} differs card vs CPU by {int(diff.max())} codes")
                flips += int((diff != 0).sum())
                total += diff.numel()
            elif k.endswith("x_scale"):
                err = abs(float(got) - float(ref))
                if err > 6.1 * lr + 1e-4 * abs(float(ref)):
                    fail(f"tiny {name} QAT: {k} differs card vs CPU by {err}")
                worst_s = max(worst_s, err / abs(float(ref)))
            elif not k.endswith("w_scale"):
                err = float((got - ref).abs().max())
                if err > 6.1 * lr:
                    fail(f"tiny {name} QAT: {k} differs card vs CPU by {err} > 6.1 lr")
                worst_w = max(worst_w, err)
        if flips > 0.01 * total:
            fail(f"tiny {name} QAT: {flips} of {total} int8 weights differ card vs CPU")
        out[name] = {"first_step_gradients": grads,
                     "losses_card": card_losses, "losses_cpu": cpu_losses,
                     "float_max_abs_diff_over_lr": worst_w / lr,
                     "x_scale_max_rel_diff": worst_s,
                     "weight_q_differ": flips, "weight_q_total": total}
    return out


CLI_TRACK_FRAMES = 30


def phase_cli_tracks(torch, card):
    """Phase 12: `run_eval_loop` over the synthetic scene's detections (the
    replay / `person_track` path) at Shelf's tracker capacities, on the card
    and on the CPU: the same track ids and byte-equal per-camera JSONs."""
    import tempfile

    from tpupose_torch.cli import common as cli
    from tpupose_torch.data.config import config_from_raw, tracker_config_from
    from tpupose_torch.eval import write_2d_result
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.ops import lap
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.utils.timing import StageTimer

    with tempfile.TemporaryDirectory() as root:
        cfg = config_from_raw(shelf_config(root, "", ""))
        views = len(cfg.dataset.folders_order)
        tcfg = tracker_config_from(cfg, num_cameras=views)
        scene, source = cli.synthetic_frame_source(num_frames=CLI_TRACK_FRAMES, num_cameras=views,
                                                   max_dets=tcfg.max_dets)
        items = list(source)
        cams = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
        runs = {}
        for device in ("cuda", "cpu"):
            pipe = Pipeline(cams, tcfg, device=device)
            lap.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (counted_syncs() if device == "cuda" else contextlib.nullcontext({})) as counted:
                multi_poses3d, annotations = cli.run_eval_loop(cfg, pipe, iter(items),
                                                               StageTimer(), clip=CLI_CLIP)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            save_dir = os.path.join(root, device)
            write_2d_result((scene.height, scene.width), annotations, save_dir=save_dir)
            jsons = {}
            for fname in sorted(os.listdir(save_dir)):
                with open(os.path.join(save_dir, fname), "rb") as f:
                    jsons[fname] = f.read()
            ids = [(a["timestamp"], a["cid"], a["pid"]) for a in annotations]
            runs[device] = (multi_poses3d, ids, jsons, seconds,
                            (counted.get("syncs"), lap.launches))
    (p_card, ids_card, js_card, s_card, counts), (p_cpu, ids_cpu, js_cpu, s_cpu, _) = (
        runs["cuda"], runs["cpu"])
    if ids_card != ids_cpu:
        fail("CLI tracks: the card's track ids differ from the CPU's")
    if js_card != js_cpu or not js_card:
        fail(f"CLI tracks: per-camera JSONs differ card vs CPU or are missing "
             f"({sorted(js_card)} / {sorted(js_cpu)})")
    worst = 0.0
    for t, pts in p_cpu.items():
        if pts.shape != p_card[t].shape:
            fail(f"CLI tracks frame {t}: {p_card[t].shape} poses on the card, {pts.shape} on the CPU")
        if pts.size:
            worst = max(worst, float(abs(pts - p_card[t]).max()))
    confirmed = sum(len(p) for p in p_card.values())
    if confirmed < 1:
        fail("CLI tracks: no confirmed track on a 3-person scene")
    return {"card": card, "frames": CLI_TRACK_FRAMES,
            "capacities": [tcfg.max_dets, tcfg.max_tracks, tcfg.max_hyp],
            "track_ids": len({pid for _, _, pid in ids_card}),
            "confirmed_track_frames": confirmed, "annotations": len(ids_card),
            "camera_jsons": len(js_card), "json_bytes": sum(map(len, js_card.values())),
            "pose3d_max_abs_diff_m": worst, "card_ms_per_frame": s_card * 1e3 / CLI_TRACK_FRAMES,
            "cpu_ms_per_frame": s_cpu * 1e3 / CLI_TRACK_FRAMES,
            "card_host_syncs_per_frame": counts[0] / CLI_TRACK_FRAMES,
            "card_k3_launches_per_frame": counts[1] / CLI_TRACK_FRAMES}


TRAIN_BATCH, TRAIN_STEPS, RESUME_AT = 8, 20, 10  # phase 13 (a), (b), (d)
TRAIN_TIMED_FROM = 5     # ms per step: median of steps 5..20 (1-based)
TF32_STEPS = 6           # (b) again with TF32 on, for the record
LEARN_STEPS = 2000       # phase 13 (e), tests/test_int8_learned_accuracy.py's
#: the tiny model's weights (torch.Generator seed): of seeds 0-7 on the card
#: (`--learned-seeds`), the one that learned with the most margin
LEARN_SEED = 4
#: phase 13 (e)'s gates: the learned model decodes to < LEARNED_PX and to
#: less than LEARN_GAIN of its untrained error; int8 within INT8_PX of it
LEARNED_PX, LEARN_GAIN, INT8_PX = 25.0, 0.5, 2.0
#: worst-leaf relative norm of the first training step's gradients on the
#: tiny config, card against CPU (TF32 off), by train_bn; set from readings
#: on the H100 (PERF.md section 6). The resumed step of phase 13 (d) is held
#: to the train_bn=False limit.
TRAIN_GRAD_LIMITS = {False: 1e-5, True: 1e-4}
E2E_FRAMES, E2E_ACTORS, E2E_BATCH = 20, 2, 16  # phase 14: 200 crops, 13 K1 launches


def named_trained(tt, model):
    """[(name, tensor)] of what `trained_tensors` gives: the parameters and
    the BN running statistics."""
    ids = {id(t) for t in tt.trained_tensors(model)}
    return [(n, t) for n, t in list(model.named_parameters()) + list(model.named_buffers())
            if id(t) in ids]


def trained_grads(tt, model):
    return {n: t.grad.detach().cpu() for n, t in named_trained(tt, model)}


def first_step_gradients(torch, tt, model, batch, train_bn):
    """{name: gradient} of one `make_train_step` step (AdamW, f32) of
    `model` on `batch`, for every tensor `trained_tensors` gives."""
    opt = tt.make_optimizer([t for _, t in named_trained(tt, model)])
    tt.make_train_step(model, opt, torch.float32, train_bn)(*batch)
    return trained_grads(tt, model)


def worst_rel(torch, got, ref):
    """(largest relative norm over the leaves, its leaf name); a leaf whose
    reference is all zero counts its own norm."""
    worst = (0.0, "")
    for name, r in ref.items():
        g = got[name].double()
        den = float(torch.linalg.vector_norm(r.double()))
        err = float(torch.linalg.vector_norm(g - r.double()))
        worst = max(worst, (err / den if den else err, name))
    return worst


def train_steps(torch, step, batches, steps):
    """Run `steps` steps, each on next(batches) (made before its clock
    starts), each timed to a device sync. Returns (losses, ms)."""
    losses, ms = [], []
    for _ in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def timed_median(ms):
    return statistics.median(ms[TRAIN_TIMED_FROM - 1:])


def blob_batches(tt, rng, cfg, n, fixed=False, scale=1.0):
    """An endless iterator of (images, targets, weights) blob batches on the
    card: the same one again if `fixed`, else a fresh one each time."""
    batch = None
    while True:
        if batch is None or not fixed:
            imgs, kps = tt.blob_localization_batch(rng, cfg, n)
            targets, weights = tt.gaussian_target_heatmaps(cfg, kps)
            batch = (imgs, targets * scale, weights)
        yield batch


def check_resume(torch, tt, model, opt, step, batch, root):
    """Phase 13 (d): save the model and the optimizer, restore them into
    fresh objects, hold every tensor torch.equal, then take one more step
    from each on `batch` (cuDNN deterministic) and compare the gradients."""
    import copy

    from tpupose_torch.models.checkpoint import restore_params, save_params

    paths = (os.path.join(root, "model.pt"), os.path.join(root, "optimizer.pt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_params(paths[0], model.state_dict())
    save_params(paths[1], opt.state_dict())
    save_s = time.perf_counter() - t0
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for t in fresh.state_dict().values():
            t.zero_()
    t0 = time.perf_counter()
    restore_params(paths[0], like=fresh)
    fresh_opt = tt.make_optimizer(tt.trained_tensors(fresh))
    restore_params(paths[1], like=fresh_opt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    tensors = 0
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        if not torch.equal(a, b):
            fail(f"resume: {k} differs after restore_params")
        tensors += 1
    for p, q in zip(opt.param_groups[0]["params"], fresh_opt.param_groups[0]["params"]):
        sa, sb = opt.state[p], fresh_opt.state[q]
        if set(sa) != set(sb) or not all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa):
            fail("resume: an optimizer state tensor differs after restore_params")
        tensors += len(sa)
    fresh_step = tt.make_train_step(fresh, fresh_opt, torch.bfloat16)
    torch.backends.cudnn.deterministic = True
    try:
        loss_a, loss_b = step(*batch), fresh_step(*batch)
    finally:
        torch.backends.cudnn.deterministic = False
    worst, where = worst_rel(torch, trained_grads(tt, fresh), trained_grads(tt, model))
    if not worst <= TRAIN_GRAD_LIMITS[False]:
        fail(f"resume: the next step's gradient of {where} differs by {worst}")
    sizes = {"model_mb": os.path.getsize(paths[0]) / 1e6,
             "optimizer_mb": os.path.getsize(paths[1]) / 1e6}
    del fresh, fresh_opt, fresh_step
    return {"tensors_equal": tensors, **sizes, "save_s": save_s, "restore_s": restore_s,
            "next_step_losses": [float(loss_a), float(loss_b)],
            "next_step_losses_equal": bool(torch.equal(loss_a, loss_b)),
            "next_step_grad_worst_rel": worst, "next_step_grad_worst_at": where,
            "cudnn_deterministic": True}


def train_grads_card_vs_cpu(torch, tt):
    """Phase 13 (c): the tiny config's first-step gradients (AdamW, f32, TF32
    off) on a blob batch of TRAIN_BATCH, card against CPU, in both train_bn
    modes: worst leaf by relative norm, running statistics included."""
    import copy

    import numpy as np

    from tpupose_torch.models.hrnet import hrnet_init, tiny_test_config

    cfg = tiny_test_config()
    imgs, kps = tt.blob_localization_batch(np.random.default_rng(1), cfg, TRAIN_BATCH,
                                           device="cpu")
    targets, weights = tt.gaussian_target_heatmaps(cfg, kps)
    out = {}
    for train_bn in (False, True):
        model = hrnet_init(cfg, torch.Generator().manual_seed(22))
        grads = {dev: first_step_gradients(
                     torch, tt, copy.deepcopy(model).to(dev),
                     [t.to(dev) for t in (imgs, targets, weights)], train_bn)
                 for dev in ("cuda", "cpu")}
        worst, where = worst_rel(torch, grads["cuda"], grads["cpu"])
        stats = [n for n in grads["cpu"] if n.endswith(("running_mean", "running_var"))]
        if not stats or (train_bn and any(grads["cuda"][n].any() for n in stats)):
            fail(f"tiny train card vs CPU (train_bn={train_bn}): running statistics "
                 "missing or not zero-gradient")
        out[f"train_bn_{train_bn}"] = {"tensors": len(grads["cpu"]), "worst_rel": worst,
                                       "worst_at": where, "limit": TRAIN_GRAD_LIMITS[train_bn]}
        if not worst <= TRAIN_GRAD_LIMITS[train_bn]:
            fail(f"tiny train card vs CPU (train_bn={train_bn}): first-step gradient of "
                 f"{where} differs by a relative norm of {worst}")
    return out


def decode_error_px(torch, model, cfg, imgs, kps):
    """Mean decoded keypoint error (crop px) of `model` in f32 on `imgs`,
    decoded with K1 over whole-crop boxes."""
    from tpupose_torch.ops.heatmap import decode_heatmaps_auto

    h, w = cfg.input_size
    boxes = torch.tensor([[0.0, 0.0, w, h]], device="cuda").repeat(imgs.shape[0], 1)
    with torch.inference_mode():
        dec = decode_heatmaps_auto(model(imgs, torch.float32), boxes)
    return float(torch.linalg.norm(dec[..., :2] - kps[..., :2], dim=-1).mean())


@contextlib.contextmanager
def k2_held_to_plain(torch, what):
    """While open, each int8 conv that a quantized model runs
    (`layers.int8_conv`, K2 on the card) is held torch.equal to
    `int8_conv_plain` on the same input, as phase 4 holds K2 (the plain
    calls launch nothing). Yields a report: the convs held, how many took
    the gather route, and the number of distinct (input shape, Cout, k,
    stride, dtype)."""
    from tpupose_torch.models import layers
    from tpupose_torch.ops import int8_conv as k2

    inner = layers.int8_conv
    report = {"convs": 0, "stem_convs": 0, "gather_convs": 0, "distinct_shapes": set()}

    def held(x, weight_q, weight_k, inv, mul, add, out_dtype, stride=1, dilation=1):
        y = inner(x, weight_q, weight_k, inv, mul, add, out_dtype, stride, dilation)
        ref = k2.int8_conv_plain(x.contiguous(), weight_q, inv, mul, add, out_dtype, stride,
                                 dilation)
        if not torch.equal(y, ref):
            fail(f"{what}: K2 at {tuple(x.shape)} -> {tuple(y.shape)} {x.dtype} -> {out_dtype} "
                 f"differs from the plain version by up to "
                 f"{float((y.float() - ref.float()).abs().max())}")
        report["convs"] += 1
        stem = k2.stem_path(x.shape[1], *weight_q.shape[2:])
        report["stem_convs"] += stem
        report["gather_convs"] += not (stem or k2.channels_last(x.shape[1]))
        report["distinct_shapes"].add((*x.shape, weight_q.shape[0], weight_q.shape[2], stride,
                                       str(x.dtype)))
        return y

    layers.int8_conv = held
    try:
        yield report
    finally:
        layers.int8_conv = inner
        report["distinct_shapes"] = len(report["distinct_shapes"])


def learned_tiny(torch, tt, seed=LEARN_SEED, gate=True):
    """Phase 13 (e): the tiny HRNet (weights from `seed`) trained on the card
    to localize blobs (Adam 1e-3, f32, LEARN_STEPS steps on one batch of
    TRAIN_BATCH, targets x 10, cuDNN deterministic so that a seed's reading
    repeats), folded, decoded (< LEARNED_PX and < LEARN_GAIN of the
    untrained error), then quantized and decoded again (within INT8_PX of
    the float model) with every K2 call held equal to the plain version.
    `gate=False` reports without failing on the errors."""
    import numpy as np

    from tpupose_torch.models import quantize as tq
    from tpupose_torch.models.hrnet import hrnet_init, tiny_test_config
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2

    cfg = tiny_test_config()
    imgs, kps = tt.blob_localization_batch(np.random.default_rng(0), cfg, TRAIN_BATCH)
    targets, weights = tt.gaussian_target_heatmaps(cfg, kps)
    targets = targets * 10.0
    model = hrnet_init(cfg, torch.Generator().manual_seed(seed)).cuda()
    untrained = decode_error_px(torch, model, cfg, imgs, kps)
    opt = torch.optim.Adam(tt.trained_tensors(model), lr=1e-3)
    step = tt.make_train_step(model, opt, torch.float32)
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LEARN_STEPS):
            loss = step(imgs, targets, weights)
        last = float(loss)
        train_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    folded = fold_batchnorm(model)
    float_px = decode_error_px(torch, folded, cfg, imgs, kps)
    if gate and not (float_px < LEARNED_PX and float_px < LEARN_GAIN * untrained):
        fail(f"learned tiny HRNet (seed {seed}): decoded error {float_px} px, expected < "
             f"{LEARNED_PX} and < {LEARN_GAIN} x the untrained {untrained} px")
    qmodel = tq.quantize_hrnet(folded, cfg, imgs)
    th.launches = k2.launches = k2.quantize_launches = k2.stem_launches = 0
    with k2_held_to_plain(torch, "learned tiny HRNet int8") as held:
        int8_px = decode_error_px(torch, qmodel, cfg, imgs, kps)
    launches = {"k1": th.launches, "k2": k2.launches, "k2a": k2.quantize_launches,
                "k2_stem": k2.stem_launches}
    if (launches["k1"] != 1 or launches["k2"] < 1 or launches["k2"] != held["convs"]
            or launches["k2_stem"] != held["stem_convs"]):
        fail(f"learned tiny HRNet int8 decode launched {launches}, {held['convs']} convs held")
    if gate and not abs(int8_px - float_px) < INT8_PX:
        fail(f"learned tiny HRNet: int8 decodes to {int8_px} px, the float model to "
             f"{float_px} px (more than {INT8_PX} apart)")
    return {"seed": seed, "steps": LEARN_STEPS, "seconds": train_s,
            "ms_per_step": train_s * 1e3 / LEARN_STEPS, "cudnn_deterministic": True,
            "last_loss": last, "untrained_px": untrained, "float_px": float_px,
            "int8_px": int8_px, "int8_launches": launches, "k2_held_to_plain": held,
            "limits": {"float_px": LEARNED_PX, "gain": LEARN_GAIN, "int8_px": INT8_PX}}, \
        (cfg, folded, qmodel)


def phase_train(torch, card):
    """Phase 13: HRNet-W48 384x288 training at full width on blob batches:
    (a) the JAX default recipe with save / resume (d) at RESUME_AT, (b) the
    JAX package's learning recipe, (c) the tiny config card vs CPU, (e) a
    learned tiny model. Returns the report and (b)'s model and last batch
    for phase 14."""
    import tempfile

    import numpy as np

    from tpupose_torch.models import train as tt
    from tpupose_torch.models.hrnet import hrnet_init, hrnet_w48_config

    cfg = hrnet_w48_config()
    out = {"card": card, "config": f"HRNet-W48 384x288, blob batches of {TRAIN_BATCH}",
           "tf32": bool(torch.backends.cudnn.allow_tf32)}

    # (a) make_optimizer(), bf16, train_bn=False, one batch; (d) at RESUME_AT
    model = hrnet_init(cfg, torch.Generator().manual_seed(20)).cuda()
    opt = tt.make_optimizer(tt.trained_tensors(model))
    step = tt.make_train_step(model, opt, torch.bfloat16)
    batches = blob_batches(tt, np.random.default_rng(0), cfg, TRAIN_BATCH, fixed=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = train_steps(torch, step, batches, RESUME_AT)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory() as root:
        resume = check_resume(torch, tt, model, opt, step, next(batches), root)
    more_losses, more_ms = train_steps(torch, step, batches, TRAIN_STEPS - RESUME_AT - 1)
    losses += [resume["next_step_losses"][0]] + more_losses
    ms += [None] + more_ms  # the resumed step ran with cuDNN deterministic
    if not losses[-1] < losses[0]:
        fail(f"W48 training (a): the loss went from {losses[0]} to {losses[-1]}")
    timed = [t for t in ms[TRAIN_TIMED_FROM - 1:] if t is not None]
    out["a"] = {"recipe": "make_optimizer() (AdamW 1e-3, wd 1e-4), bf16, train_bn=False, "
                          "one batch", "steps": TRAIN_STEPS, "losses": losses, "step_ms": ms,
                "ms_per_step": statistics.median(timed), "peak_mem_gib": peak}
    out["d"] = resume
    del model, opt, step

    # (b) the JAX package's learning recipe: Adam 1e-3, f32, train_bn, fresh batches
    model = hrnet_init(cfg, torch.Generator().manual_seed(23)).cuda()
    opt = torch.optim.Adam(tt.trained_tensors(model), lr=1e-3)
    step = tt.make_train_step(model, opt, torch.float32, train_bn=True)
    batches = blob_batches(tt, np.random.default_rng(1), cfg, TRAIN_BATCH, scale=10.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = train_steps(torch, step, batches, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_losses, tf32_ms = train_steps(torch, step, batches, TF32_STEPS)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ms_b = timed_median(ms)
    out["b"] = {"recipe": "Adam 1e-3, f32, train_bn=True, a fresh batch per step, targets x 10 "
                          "(scripts/int8_w48_agreement.py:395-414)",
                "steps": TRAIN_STEPS, "losses": losses, "step_ms": ms, "ms_per_step": ms_b,
                "peak_mem_gib": peak, "extrapolated_4000_steps_s": 4000 * ms_b / 1e3,
                "tf32_steps": TF32_STEPS, "tf32_losses": tf32_losses, "tf32_step_ms": tf32_ms,
                "tf32_ms_per_step": statistics.median(tf32_ms[1:])}
    last_batch = next(batches)
    del opt, step

    out["c"] = train_grads_card_vs_cpu(torch, tt)
    out["e"], tiny = learned_tiny(torch, tt)
    return out, (cfg, model, last_batch[0]), tiny


def pcp_summary(res, seconds):
    return {"average_pcp": res["average"] * 100, "stage_b_s": seconds,
            "table": res["table"].splitlines()}


def timed_pcp(torch, e2e, scene, kps, device):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = e2e.pcp_through_tracker(scene, kps, device=device)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_e2e(torch, card, w48, tiny):
    """Phase 14: phase 13's W48 (BN statistics re-estimated on its batch,
    folded to bf16) through the PCP chain: scene crops, `decode_tree` (K1
    counted, each batch held against the plain decode of its heatmaps),
    `pcp_through_tracker` with perfect detections on the card and the CPU,
    then the W48's and the learned tiny model's (bf16, int8) keypoints."""
    import numpy as np

    from tpupose_torch.eval import e2e
    from tpupose_torch.models import quantize as tq
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2

    cfg, model, images = w48
    tq.calibrate_bn_stats(lambda b: model(b, torch.float32), images)
    folded = fold_batchnorm(model, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    scene, crops, eboxes = e2e.build_scene_crops(cfg, num_frames=E2E_FRAMES,
                                                 num_actors=E2E_ACTORS)
    out = {"card": card, "crops": int(crops.shape[0]), "crop_shape": list(crops.shape[1:]),
           "build_s": time.perf_counter() - t0}

    recorded, inner = [], th.decode_heatmaps_auto

    def record(heat, boxes, refine=True):
        kps = inner(heat, boxes, refine)
        recorded.append((heat, boxes, kps))
        return kps

    torch.cuda.synchronize()
    th.decode_heatmaps_auto = record
    th.launches = 0
    t0 = time.perf_counter()
    try:
        kps = e2e.decode_tree(folded, cfg, crops, eboxes, "quarter", batch=E2E_BATCH)
    finally:
        th.decode_heatmaps_auto = inner
    launches = th.launches
    out["decode_s"] = time.perf_counter() - t0
    expect = -(-crops.shape[0] // E2E_BATCH)
    if launches != expect or len(recorded) != expect:
        fail(f"decode_tree launched K1 {launches} times, expected {expect}")
    err = 0.0
    for heat, boxes, got in recorded:
        ref = th.decode_heatmaps(heat, boxes, "quarter")
        check_equal_nan(got[..., 2], ref[..., 2], "decode_tree K1 scores")
        err = max(err, check_equal_nan(got[..., :2], ref[..., :2], "decode_tree K1 coordinates",
                                       ulps=1))
    if kps.shape != (crops.shape[0], 17, 3) or not np.isfinite(kps).all():
        fail(f"decode_tree gave {kps.shape} keypoints, or non-finite ones")
    out.update(k1_launches=launches, k1_vs_plain_max_abs_err=err)

    T, C, A = scene.num_frames, scene.num_cameras, scene.num_actors
    perfect = np.concatenate([scene.gt2d, np.full((T, C, A, 17, 1), 10.0)], axis=-1)
    perfect = perfect.astype(np.float32).reshape(T * C * A, 17, 3)
    card_res, card_s = timed_pcp(torch, e2e, scene, perfect, "cuda")
    cpu_res, cpu_s = timed_pcp(torch, e2e, scene, perfect, "cpu")
    if not (np.array_equal(card_res["check_result"], cpu_res["check_result"])
            and card_res["table"] == cpu_res["table"]):
        fail("PCP with perfect detections: the card's table differs from the CPU's")
    if not card_res["average"] * 100 >= 99.0:
        fail(f"PCP with perfect detections: {card_res['average'] * 100} < 99")
    out["perfect"] = {**pcp_summary(card_res, card_s), "cpu_stage_b_s": cpu_s,
                      "tables_equal_cpu": True}
    out["w48"] = pcp_summary(*timed_pcp(torch, e2e, scene, kps, "cuda"))

    tiny_cfg, tiny_float, tiny_int8 = tiny
    _, tiny_crops, tiny_boxes = e2e.build_scene_crops(tiny_cfg, scene=scene)
    for name, m in (("tiny_bf16", tiny_float), ("tiny_int8", tiny_int8)):
        th.launches = k2.launches = k2.stem_launches = 0
        with k2_held_to_plain(torch, f"phase 14 {name} decode_tree") as held:
            tiny_kps = e2e.decode_tree(m, tiny_cfg, tiny_crops, tiny_boxes, "quarter",
                                       batch=E2E_BATCH)
        used = {"k1": th.launches, "k2": k2.launches, "k2_stem": k2.stem_launches}
        if used["k1"] != expect or used["k2"] != held["convs"] or (
                used["k2_stem"] != held["stem_convs"]) or (
                (name == "tiny_int8") != (held["convs"] > 0)):
            fail(f"phase 14 {name}: launches {used}, {held['convs']} K2 calls held to plain")
        out[name] = {**pcp_summary(*timed_pcp(torch, e2e, scene, tiny_kps, "cuda")),
                     "launches": used, "k2_held_to_plain": held}
    return out


#: Phase 15, the multi-stream path: tracker capacities (max_dets,
#: max_tracks, max_hyp) of the clip path and of the CLI's configs.
MS_CAPS = {"4/12/24": (4, 12, 24), "16/16/40": (16, 16, 40)}
LAP_STREAMS = (1, 2, 8, 32)   # (a): 2 is (d)'s
MS_STREAMS = (1, 8, 32)       # (c)
SYNC_FREE_FRAMES, MS_FRAMES = 256, 64     # (b), (c)
CLIP_STREAMS, CLIP_FRAMES = 2, 128        # (d), bench.py's multistream leg
CLIP_HW = (720, 1280)
MS_POSE_TOL = 2e-2  # tests/test_torch_tracker.py's adversarial band, metres


def stream_scene(num_frames, seed):
    """bench.py's stage-B stream: the continuous adversarial scene."""
    from tpupose_torch.data.synthetic import make_continuous_adversarial_scene

    return make_continuous_adversarial_scene(num_frames=num_frames, num_cameras=5,
                                             num_actors=3, noise_px=1.5, seed=seed)


def stream_inputs(torch, scene, caps, device):
    """A scene's detections padded to the tracker's max_dets, its rig and the
    TrackerConfig of capacities `caps`, on `device`."""
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.tracking.tracker import TrackerConfig

    d, t, h = caps
    frames, views, actors = scene.detections.shape[:3]
    dets = torch.zeros((frames, views, d, 17, 3))
    mask = torch.zeros((frames, views, d), dtype=torch.bool)
    dets[:, :, :actors] = torch.as_tensor(scene.detections)
    mask[:, :, :actors] = torch.as_tensor(scene.visible)
    cams = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    cfg = TrackerConfig(num_cameras=views, max_dets=d, max_tracks=t, max_hyp=h)
    fids = torch.arange(frames, dtype=torch.int32)
    return (dets.to(device), mask.to(device), fids.to(device), cams.to(device), cfg)


def track_reference_cpu(caps, num_frames):
    """(b)'s CPU reference, run in a worker process while the card works:
    `track_clip` of the stream scene on the CPU."""
    import torch

    from tpupose_torch.tracking.tracker import init_state, track_clip

    torch.set_num_threads(2)
    dets, mask, fids, cams, cfg = stream_inputs(torch, stream_scene(num_frames, 1), caps, "cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, outs = track_clip(cfg, cams, init_state(cfg, "cpu"), dets, mask, fids)
    return {"seconds": time.perf_counter() - t0,
            **{f: getattr(outs, f).numpy() for f in ("track_id", "valid", "n_views", "pose3d")}}


@contextlib.contextmanager
def no_syncs(torch):
    """Any host wait on the card inside the block raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def lap_problems(torch, gen, batch, shape, kind):
    """(B, R, C) costs on the card: "uniform" (tie-free), "ties" (integers
    in [0, 3]) or "zeros" (uniform with about half the entries 0, the
    tracker's unmatched affinities, which maximizing turns into -0.0); and
    random masks. Problem 0 has no valid row, problem 1 no valid column,
    problem 2 is full."""
    r, c = shape
    if kind == "ties":
        cost = torch.randint(0, 4, (batch, r, c), generator=gen, device="cuda").float()
    else:
        cost = torch.rand((batch, r, c), generator=gen, device="cuda")
    if kind == "zeros":
        cost = torch.where(torch.rand((batch, r, c), generator=gen, device="cuda") < 0.5,
                           0.0, cost)
    rv = (torch.rand((batch, r), generator=gen, device="cuda")
          >= 0.6 * torch.rand((batch, 1), generator=gen, device="cuda"))
    cv = (torch.rand((batch, c), generator=gen, device="cuda")
          >= 0.6 * torch.rand((batch, 1), generator=gen, device="cuda"))
    rv[0] = False
    if batch > 1:
        cv[1] = False
    if batch > 2:
        rv[2], cv[2] = True, True
    return cost, rv, cv


#: A sleep of t * SLEEP_HZ cycles lasts at least t seconds: above any H100
#: SM clock.
SLEEP_HZ = 2.0e9
DEVICE_CALLS, DEVICE_RUNS = 20, 5   # (a)'s device_us: calls per run, runs
HOST_CALLS = 1000                   # (a)'s host_us, in batches of HOST_BATCH
HOST_BATCH = 250
CHAIN_STEPS = (1024, 33792)         # the step-chain microkernel's two lengths


def host_us_per_call(torch, fn):
    """The host's submission of one call, in µs: HOST_CALLS calls timed on
    the host clock in batches, each while the card sleeps (so that no call
    waits on the card, nor the launch queue on it); fails if a sleep ended
    before its batch was submitted."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * SLEEP_HZ))
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    estimate = (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(HOST_CALLS // HOST_BATCH):
        torch.cuda._sleep(int((2 * HOST_BATCH * estimate + 0.01) * SLEEP_HZ))
        busy = torch.cuda.Event()
        busy.record()
        t0 = time.perf_counter()
        for _ in range(HOST_BATCH):
            fn()
        total += time.perf_counter() - t0
        covered = not busy.query()
        torch.cuda.synchronize()
        if not covered:
            fail("host_us: the card's sleep ended before the host had submitted its calls")
    return total / HOST_CALLS * 1e6


def device_us_per_call(torch, fn, host_us):
    """The card's time for one call alone, in µs: the stream is filled with
    a sleep longer than the host's submission of DEVICE_CALLS calls, then
    events around DEVICE_CALLS back-to-back calls; the interval over the
    calls, median of DEVICE_RUNS runs."""
    fn()
    times = []
    sleep_s = 2 * DEVICE_CALLS * host_us * 1e-6 + 1e-3
    while len(times) < DEVICE_RUNS:
        torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DEVICE_CALLS):
            fn()
        end.record()
        covered = not start.query()
        end.synchronize()
        if not covered:  # the host was slower than the sleep: sleep longer
            sleep_s *= 2
            if sleep_s > 1.0:
                fail("device_us: the host could not submit its calls within a 1 s sleep")
            continue
        times.append(start.elapsed_time(end) / DEVICE_CALLS * 1e3)
    return statistics.median(times)


def step_time_us(torch, lap):
    """The card's time for one minimal dependent Dijkstra step (shared load,
    __reduce_min_sync, select) on one warp, in µs: the step-chain
    microkernel's device time at two lengths, differenced."""
    out = torch.empty(32, dtype=torch.int32, device="cuda")
    dev = {}
    for n in CHAIN_STEPS:
        call = lambda n=n: lap.step_chain(n, out)  # noqa: E731
        dev[n] = device_us_per_call(torch, call, host_us_per_call(torch, call))
    lo, hi = CHAIN_STEPS
    return (dev[hi] - dev[lo]) / (hi - lo), dev


def lap_timings(torch, fn):
    """us (one call timed by CUDA events on an idle card, host included),
    host_us and device_us of fn."""
    host_us = host_us_per_call(torch, fn)
    return {"us": cuda_time_ms(fn) * 1e3, "host_us": host_us,
            "device_us": device_us_per_call(torch, fn, host_us)}


def k3_against_plain(torch, gen):
    """(a): K3 torch.equal to the plain version on a CPU copy of the same
    inputs at the tracker's shapes, ties, zero scores and empty problems
    included; K3's times (us, host_us, device_us; op_host_us, the host's
    submission through the op the tracker calls), the plain version's (on
    the card, S <= 2), an empty kernel's, and K3's bound, by latency: the
    longest problem's Dijkstra steps (counted by the plain version) times
    the card's time for one minimal dependent step."""
    from tpupose_torch.ops import lap

    step_us, chain_us = step_time_us(torch, lap)
    shapes = []
    for s in LAP_STREAMS:
        for d, t, h in MS_CAPS.values():
            shapes += [("association", 5 * s, (t, d), True), ("init", s, (h, d), False)]
    # beyond the tracker: wider problems, the kernel's 4- and 8-column-a-lane
    # variants, one of them solved transposed
    shapes += [("wide", 8, (6, 100), False), ("wide", 8, (256, 9), True)]
    rows, checked = [], 0
    for site, batch, shape, maximize in shapes:
        # zero scores where maximizing; timed on the uniform costs, below
        for kind in ("ties", "zeros", "uniform") if maximize else ("ties", "uniform"):
            cost, rv, cv = lap_problems(torch, gen, batch, shape, kind)
            got = lap.masked_lap_cuda(cost, rv, cv, maximize).cpu()
            cost_c, rv_c, cv_c = cost.cpu(), rv.cpu(), cv.cpu()
            steps = []
            for b in range(batch):
                before = lap.dijkstra_steps
                ref = lap.masked_lap_plain(cost_c[b], rv_c[b], cv_c[b], maximize)
                steps.append(lap.dijkstra_steps - before)
                if not torch.equal(got[b], ref):
                    fail(f"K3 {site} {batch} x {shape} ({kind}) problem {b}: "
                         f"{int((got[b] != ref).sum())} rows differ from the plain version")
            checked += batch
        call = lambda: lap.masked_lap_cuda(cost, rv, cv, maximize)  # noqa: E731
        times = lap_timings(torch, call)
        # the plain version on the card reads the device per JV step: slow
        plain_ms = (cuda_time_ms(lambda: lap.masked_lap_plain(cost, rv, cv, maximize),
                                 warmup=1, reps=3) if batch <= 10 else None)
        # the tracker's path: the op `tpupose_torch::masked_lap`, then K3
        op_host_us = host_us_per_call(torch, lambda: lap.masked_lap(cost, rv, cv, maximize))
        cs = max(shape)
        moved = batch * (shape[0] * shape[1] * 4 + shape[0] + shape[1]) + batch * shape[0] * 8
        # each Dijkstra step: 7 f32 operations a column; bytes and operations
        # bound K3 far below its chain of dependent steps
        rate = bound(moved, 7 * cs * sum(steps), H100_F32_OPS_PER_S)
        rows.append({"site": site, "batch": batch, "shape": list(shape), "maximize": maximize,
                     **times, "op_host_us": op_host_us, "plain_ms": plain_ms,
                     "steps_max": max(steps), "steps_total": sum(steps),
                     "us_per_step": times["device_us"] / max(steps),
                     "bound_ms": max(steps) * step_us / 1e3, "bound_by": "latency",
                     "rate_bound_ms": rate["bound_ms"], "rate_bound_by": rate["bound_by"],
                     "bytes": moved, "ops": rate["ops"]})
    return {"problems_checked": checked, "shapes": rows, "step_us": step_us,
            "step_chain_device_us": chain_us,
            "empty_kernel": lap_timings(torch, lap.empty_launch), "max_abs_err": 0.0,
            "note": "K3 is bound by latency (dependent Dijkstra steps), not by bytes"}


def sync_free_tracker(torch, cpu_refs):
    """(b): `track_clip` on the card, inputs already there, under sync-debug
    "error", against the CPU's run of the same stream."""
    from tpupose_torch.ops import lap
    from tpupose_torch.tracking.tracker import init_state, track_clip

    scene = stream_scene(SYNC_FREE_FRAMES, 1)
    out = {}
    for name, caps in MS_CAPS.items():
        dets, mask, fids, cams, cfg = stream_inputs(torch, scene, caps, "cuda")
        runs = []
        for _ in range(2):  # the first run also warms the step up
            lap.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode(), no_syncs(torch):
                _, outs = track_clip(cfg, cams, init_state(cfg, "cuda"), dets, mask, fids)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / SYNC_FREE_FRAMES)
        ref = cpu_refs[name]
        for field in ("track_id", "valid", "n_views"):
            if not (getattr(outs, field).cpu().numpy() == ref[field]).all():
                fail(f"sync-free tracker at {name}: {field} differs between the card and the CPU")
        valid = ref["valid"]
        err = float(abs(outs.pose3d.cpu().numpy() - ref["pose3d"])[valid].max()) if valid.any() else 0.0
        if not err <= MS_POSE_TOL:
            fail(f"sync-free tracker at {name}: pose3d {err} m from the CPU's")
        out[name] = {"stage_b_ms_per_frame": runs[1], "first_run_ms_per_frame": runs[0],
                     "cpu_ms_per_frame": ref["seconds"] * 1e3 / SYNC_FREE_FRAMES,
                     "k3_launches_per_frame": lap.launches / SYNC_FREE_FRAMES,
                     "confirmed_track_frames": int(valid.sum()), "pose3d_max_abs_diff_m": err}
    return out


def multistream_tracker(torch):
    """(c): S streams of different scenes through `multistream_step`, every
    stream held to its own single-stream `track_clip` on the card."""
    from tpupose_torch.ops import lap
    from tpupose_torch.parallel import broadcast_cameras, init_multistream_state, multistream_step
    from tpupose_torch.tracking.tracker import init_state, track_clip

    scenes = [stream_scene(MS_FRAMES, seed) for seed in range(1, max(MS_STREAMS) + 1)]
    out = {}
    for name, caps in MS_CAPS.items():
        inputs = [stream_inputs(torch, sc, caps, "cuda") for sc in scenes]
        cams, cfg = inputs[0][3], inputs[0][4]
        dets = torch.stack([x[0] for x in inputs])
        mask = torch.stack([x[1] for x in inputs])
        fids = inputs[0][2]
        t0 = time.perf_counter()
        singles = []
        with torch.inference_mode():
            for d, m, f, c, _ in inputs:
                singles.append(track_clip(cfg, c, init_state(cfg, "cuda"), d, m, f)[1])
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3 / (len(inputs) * MS_FRAMES)
        runs = {}
        for s in MS_STREAMS:
            cams_s = broadcast_cameras(cams, s)
            with torch.inference_mode():  # warm-up, outside the timing
                multistream_step(cfg, cams_s, init_multistream_state(cfg, s), dets[:s, 0],
                                 mask[:s, 0], fids[0].expand(s))
            state = init_multistream_state(cfg, s)
            lap.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = []
            with torch.inference_mode(), no_syncs(torch):
                for t in range(MS_FRAMES):
                    state, o = multistream_step(cfg, cams_s, state, dets[:s, t], mask[:s, t],
                                                fids[t].expand(s))
                    outs.append(o)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / MS_FRAMES
            for field in ("track_id", "valid", "n_views"):
                got = torch.stack([getattr(o, field) for o in outs], dim=1)  # (S, F, ...)
                ref = torch.stack([getattr(x, field) for x in singles[:s]])
                if not torch.equal(got, ref):
                    fail(f"multistream at {name}, S={s}: {field} differs from the streams' "
                         f"single-stream runs")
            runs[s] = {"ms_per_step": ms, "ms_per_stream_frame": ms / s,
                       "k3_launches_per_step": lap.launches / MS_FRAMES}
        out[name] = {"single_stream_ms_per_frame": single_ms, "streams": runs}
    return out


def multistream_clip(torch, float_models):
    """(d): bench.py's multistream leg at full width, bf16 then int8."""
    import dataclasses

    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.models.quantize import (
        hrnet_skip_ids,
        quantize_convs,
        uncalibrated_scales,
        yolo_skip_ids,
    )
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2
    from tpupose_torch.ops import lap
    from tpupose_torch.parallel import (
        broadcast_cameras,
        init_multistream_state,
        make_multistream_clip_fn,
        multistream_step,
    )
    from tpupose_torch.parallel import throughput
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking.tracker import init_state, track_clip

    _, tcfg, det_cfg, detector, pose_cfg, pose = float_models
    tcfg = dataclasses.replace(tcfg, max_dets=4, max_tracks=12, max_hyp=24)
    s, f, views, (height, width) = CLIP_STREAMS, CLIP_FRAMES, 5, CLIP_HW
    scene = make_scene(num_frames=1, num_cameras=views, num_actors=3, seed=0)
    cams = make_camera_set(scene.P, scene.K, scene.RT, width, height, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(15)
    clip = torch.randint(0, 256, (s, f, views, height, width, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    fids = torch.arange(s * f, dtype=torch.int32, device="cuda").reshape(s, f)
    fn = make_multistream_clip_fn(det_cfg, pose_cfg, tcfg)
    models = {"bf16": (detector, pose)}
    models["int8"] = (
        quantize_convs(detector, uncalibrated_scales(detector, yolo_skip_ids(detector, det_cfg))),
        quantize_convs(pose, uncalibrated_scales(pose, hrnet_skip_ids(pose))))
    chunk = throughput._auto_chunk(s, f, views)
    n_chunks = f // chunk
    # K1, K2, K2a: one stage-A batch a chunk; K3: one association and one
    # init LAP a camera, a step
    expect = {mode: {"k1": n_chunks * c["heatmap.launches"],
                     "k2": n_chunks * c["int8_conv.launches"],
                     "k2a": n_chunks * c["int8_conv.quantize_launches"],
                     "k2_stem": n_chunks * c["int8_conv.stem_launches"],
                     "k3": f * (1 + views)} for mode, c in STEP_LAUNCHES.items()}
    inner = throughput._clip_detections
    out = {"config": "S=2 streams x 128 frames x 5 views of 720x1280 uint8; YOLOv3-416 "
                     "(max_candidates=4) + HRNet-W48 384x288 folded to bf16; tracker at "
                     "4 / 12 / 24; int8 by quantize_convs + uncalibrated_scales",
           "chunk_frames": chunk}
    for mode, (det_m, pose_m) in models.items():
        stage_a = []

        def recording(*args):
            dm = inner(*args)
            stage_a.append(dm)
            return dm

        throughput._clip_detections = recording
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            th.launches = k2.launches = k2.quantize_launches = k2.stem_launches = 0
            lap.launches = 0
            t0 = time.perf_counter()
            with counted_syncs() as counted:
                states, outs = fn(det_m, pose_m, broadcast_cameras(cams, s),
                                  init_multistream_state(tcfg, s), clip, fids)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            throughput._clip_detections = inner
        launches = {"k1": th.launches, "k2": k2.launches, "k2a": k2.quantize_launches,
                    "k2_stem": k2.stem_launches, "k3": lap.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != expect[mode]:
            fail(f"multistream clip ({mode}) launched {launches}, expected {expect[mode]}")
        dets = torch.cat([d.reshape(s, -1, views, 4, 17, 3) for d, _ in stage_a], dim=1)
        mask = torch.cat([m.reshape(s, -1, views, 4) for _, m in stage_a], dim=1)
        if tuple(outs.pose3d.shape) != (s, f, 12, 17, 3) or not (
                torch.isfinite(dets).all() and torch.isfinite(outs.pose3d).all()):
            fail(f"multistream clip ({mode}): shapes {tuple(outs.pose3d.shape)} or non-finite")
        # the split, each stage alone to a sync
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for k in range(0, f, chunk):
                inner(det_cfg, pose_cfg, tcfg, det_m, pose_m,
                      clip[:, k:k + chunk].reshape(-1, height, width, 3))
        torch.cuda.synchronize()
        stage_a_s = time.perf_counter() - t0
        state = init_multistream_state(tcfg, s)
        cams_s = broadcast_cameras(cams, s)
        t0 = time.perf_counter()
        with torch.inference_mode():
            for t in range(f):
                state, _ = multistream_step(tcfg, cams_s, state, dets[:, t], mask[:, t], fids[:, t])
        torch.cuda.synchronize()
        stage_b_s = time.perf_counter() - t0
        # each stream's stage B against track_clip fed its own detections
        with torch.inference_mode():
            for i in range(s):
                _, ref = track_clip(tcfg, cams, init_state(tcfg, "cuda"), dets[i], mask[i], fids[i])
                for field in ("track_id", "valid", "n_views", "pose2d_now"):
                    if not torch.equal(getattr(outs, field)[i], getattr(ref, field)):
                        fail(f"multistream clip ({mode}) stream {i}: {field} differs from "
                             f"track_clip on its stage-A detections")
        run = {"seconds": seconds, "fps": s * f / seconds, "stage_a_s": stage_a_s,
               "stage_b_s": stage_b_s, "stage_b_ms_per_step": stage_b_s * 1e3 / f,
               "launches": launches, "peak_mem_gib": peak,
               "host_syncs": counted["syncs"], "detections_valid": int(mask.sum())}
        if mode == "bf16":  # information: process_clip's stage A on the same frames
            pipe = Pipeline(cams, tcfg, det_cfg, det_m, pose_cfg, pose_m)
            equal = total = 0
            for i in range(s):
                for k in range(0, f, 32):
                    _, m = pipe.process_clip_nn(clip[i, k:k + 32])
                    equal += int((m == mask[i, k:k + 32]).sum())
                    total += m.numel()
            run["masks_equal_share_vs_process_clip"] = equal / total
            del pipe
        out[mode] = run
        del stage_a, dets, mask, states, outs
    del clip, models
    return out


def phase_multistream(torch, card, gen, float_models):
    """Phase 15: the multi-stream path (see the module docstring)."""
    import multiprocessing

    t_phase = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(len(MS_CAPS))
    try:
        pending = {name: pool.apply_async(track_reference_cpu, (caps, SYNC_FREE_FRAMES))
                   for name, caps in MS_CAPS.items()}
        k3 = k3_against_plain(torch, gen)
        emit("multistream_k3", card=card, **k3)
        tracker = multistream_tracker(torch)
        emit("multistream_tracker", card=card, **tracker)
        cpu_refs = {name: job.get(timeout=900) for name, job in pending.items()}
    finally:
        pool.terminate()
        pool.join()
    sync_free = sync_free_tracker(torch, cpu_refs)
    emit("sync_free_tracker", card=card, **sync_free)
    clip = multistream_clip(torch, float_models)
    return {"card": card, "k3": k3, "sync_free": sync_free, "tracker": tracker,
            "clip": clip, "seconds": time.perf_counter() - t_phase}


def main():
    args = sys.argv[1:]
    seeds = only = None
    if args:
        if args[0] == "--learned-seeds" and len(args) > 1 and all(a.isdigit() for a in args[1:]):
            seeds = [int(a) for a in args[1:]]
        elif args[0] == "--only" and len(args) > 1 and set(args[1:]) <= {"k2", "k3"}:
            only = set(args[1:])
        else:
            fail("usage: chip_smoke.py [--learned-seeds SEED ... | --only k2|k3 ...]", 2)
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

    if seeds is not None:
        from tpupose_torch.models import train as tt

        for seed in seeds:
            emit("learned_tiny", card=card, **learned_tiny(torch, tt, seed, gate=False)[0])
        return

    gen = torch.Generator(device="cuda").manual_seed(0)
    if only is not None:
        if "k2" in only:
            emit("k2_vs_plain", **phase_k2(torch, gen, card))
        if "k3" in only:
            emit("multistream_k3", card=card, **k3_against_plain(torch, gen))
        return
    k1 = phase_kernel(th, torch, gen)
    emit("k1_vs_plain", card=card, **k1)

    k2 = phase_k2(torch, gen, card)
    emit("k2_vs_plain", **k2)

    main_path, state = phase_main_path(torch, gen, card)
    emit("main_path", **main_path)
    pipe, clip, frame_ids = state[:3]
    # the float models, for phase 11 (phase 6 serves int8 copies of them)
    float_models = (pipe.cams, pipe.tracker_cfg, pipe.det_cfg, pipe.detector,
                    pipe.pose_cfg, pipe.pose_model)

    int8 = phase_int8_path(torch, card, state)
    emit("int8_main_path", **int8)

    emit("int8_resident", **phase_resident(torch, card, pipe, clip))
    emit("staged_api", **phase_staged(torch, card, pipe, clip, frame_ids))
    pack = phase_pack(torch, card, pipe, float_models, clip, frame_ids)  # phase 16 (c)
    emit("pack", **pack)
    del pipe, state
    # phases 11 and 15 before 9 and 10, so that phase 10's peak memory
    # holds none of phase 5's models or its clip
    emit("int8_qat", **phase_int8_qat(torch, card, float_models, clip, frame_ids))
    multistream = phase_multistream(torch, card, gen, float_models)
    emit("multistream", **multistream)
    del float_models, clip

    tracker = phase_tracker(torch, card)
    emit("tracker_scene", **tracker)

    cli_path, bundles = phase_cli_path(torch, card)
    emit("cli_path", **cli_path)
    emit("bundle_pack", a=bundles["bf16"], b=bundles["int8"], c=pack,
         load_s_from_checkpoints=bundles["load_s_from_checkpoints"])
    cli_launches = {mode: cli_path[mode]["launches"] for mode in ("bf16", "int8")}

    emit("cli_tracks", **phase_cli_tracks(torch, card))

    train, w48, tiny = phase_train(torch, card)
    emit("train", **train)
    e2e = phase_e2e(torch, card, w48, tiny)
    emit("e2e", **e2e)
    del w48, tiny

    quarter = k1["modes"]["quarter"]
    conv, packed = k2["timed"]["hrnet_branch0_3x3_48"], k2["timed"]["hrnet_branch0_packed_3x3_96"]
    stem, yolo_stem = k2["timed"]["hrnet_stem_3x3_s2_3_64"], k2["timed"]["yolo_stem_3x3_3_32"]
    ms_launches = {mode: multistream["clip"][mode]["launches"] for mode in ("bf16", "int8")}
    # K3 at the multi-stream clip's association: S=2 streams x 5 views of (12, 4)
    k3 = next(r for r in multistream["k3"]["shapes"]
              if r["site"] == "association" and r["batch"] == 10 and r["shape"] == [12, 4])
    print(json.dumps({"kernels": [{
        "name": "heatmap_decode", "route": "cuda",
        "source": "tpupose_torch/csrc/heatmap_decode.cu",
        "replaces": "tpupose/ops/pallas_heatmap.py:69",
        "launches": int8["k1_launches"],
        "max_abs_err": k1["max_abs_err"], "ms": quarter["ms"],
        "plain_ms": quarter["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "cli_launches": {m: c["heatmap.launches"] for m, c in cli_launches.items()},
        "e2e_launches": e2e["k1_launches"],
        "multistream_launches": {m: c["k1"] for m, c in ms_launches.items()},
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
        "packed_branch0": {
            "shape": packed["shape"], "ms": packed["ms"], "plain_ms": packed["plain_ms"],
            "bound_ms": packed["bound_ms"], "bound_by": packed["bound_by"],
            "k2b_ms": packed["k2b"]["ms"], "k2b_bound_ms": packed["k2b"]["bound_ms"],
            "bf16_cudnn_ms": packed["bf16_cudnn_ms"],
            "bf16_cudnn_bound_ms": packed["bf16_cudnn_bound"]["bound_ms"],
            "launches_per_packed_clip": pack["int8"]["k2_launches_at_packed_shape_P"],
            "unpacked": {"ms": conv["ms"], "k2b_ms": conv["k2b"]["ms"],
                         "k2b_bound_ms": conv["k2b"]["bound_ms"],
                         "bf16_cudnn_ms": conv["bf16_cudnn_ms"],
                         "bf16_cudnn_bound_ms": conv["bf16_cudnn_bound"]["bound_ms"]}},
        "bundle_launches": bundles["int8"]["loop"]["launches"]["int8_conv.launches"],
        "cli_launches": {m: c["int8_conv.launches"] for m, c in cli_launches.items()},
        "learned_int8_launches": train["e"]["int8_launches"]["k2"],
        "multistream_launches": {m: c["k2"] for m, c in ms_launches.items()},
    }, {
        "name": "int8_stem", "route": "cuda",
        "source": "tpupose_torch/csrc/int8_conv.cu",
        "replaces": "tpupose/models/quantize.py:210",
        "launches": int8["stem_launches"],
        "max_abs_err": k2["stem_max_abs_err"], "ms": stem["ms"],
        "plain_ms": stem["plain_ms"], "bound_ms": stem["bound_ms"],
        "bound_by": stem["bound_by"], "library_ms": None,
        "gather_ms": stem["gather_ms"], "bf16_cudnn_ms": stem["bf16_cudnn_ms"],
        "shape": stem["shape"], "yolo_stem": {
            f: yolo_stem[f] for f in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "gather_ms", "bf16_cudnn_ms")},
        "cli_launches": {m: c["int8_conv.stem_launches"] for m, c in cli_launches.items()},
        "learned_int8_launches": train["e"]["int8_launches"]["k2_stem"],
        "multistream_launches": {m: c["k2_stem"] for m, c in ms_launches.items()},
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
        "learned_int8_launches": train["e"]["int8_launches"]["k2a"],
        "multistream_launches": {m: c["k2a"] for m, c in ms_launches.items()},
    }, {
        "name": "masked_lap", "route": "cuda",
        "source": "tpupose_torch/csrc/lap.cu",
        "replaces": "tpupose/ops/lap.py:114",
        "launches": ms_launches["int8"]["k3"],
        "max_abs_err": multistream["k3"]["max_abs_err"], "ms": k3["us"] / 1e3,
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None, "us": k3["us"],
        "device_us": k3["device_us"], "host_us": k3["host_us"],
        "op_host_us": k3["op_host_us"], "rate_bound_ms": k3["rate_bound_ms"],
        "steps_max": k3["steps_max"], "step_us": multistream["k3"]["step_us"],
        "shape": [k3["batch"]] + k3["shape"],
        "empty_kernel_ms": multistream["k3"]["empty_kernel"]["us"] / 1e3,
        "clip_launches": int8["k3_launches"], "cli_launches": {
            m: cli_path[m]["k3_launches"] for m in ("bf16", "int8")},
        "multistream_launches": {m: c["k3"] for m, c in ms_launches.items()},
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
