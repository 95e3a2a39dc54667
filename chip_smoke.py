#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`tpupose_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --learned-seeds 0 1 2   # phase 13 (e) per seed, no gates
    python3 chip_smoke.py --only k2 k3            # phases 4 and 15 (a) alone
    python3 chip_smoke.py --only ingest           # phase 17 alone
    python3 chip_smoke.py --only parallel         # phase 18 alone, one rank per card
    python3 chip_smoke.py --only graphs           # phase 19 alone
    python3 chip_smoke.py --only train            # phase 13 alone, then its profile
    python3 chip_smoke.py --only epilogue         # phase 21 alone: the conv epilogue
    python3 chip_smoke.py --only vitpose          # phase 22 alone: ViTPose-H on the main path

Phases, in order (but 11 and 15 run after 8, so that phase 10's peak
memory holds none of phase 5's models, 16 in two parts, (c) after 8
and (a), (b) inside 10, and 17 inside 10, after 16 (a), (b), on phase 10's
checkpoint files); the first that fails ends the run
with a non-zero exit. "Host syncs" are the host's waits on the card inside
the pipeline's calls, counted under torch.cuda.set_sync_debug_mode("warn")
(`counted_syncs`); K3 launches are counted where the tracker runs. The
tracker step runs as a captured CUDA graph wherever the pipeline runs it
(`runtime.graphs`): its replays on the card are counted in phases 5, 6,
8, 9, 10, 12 and 18 (b), each as many as the frames it tracked, and a
graph first captured inside a counted window adds its warm-up's K3
launches (`graph_k3_warmups`), which ran. The training steps (phases 11, 13,
18's reference) are captured CUDA graphs too (`runtime.graphs.CapturedUpdate`:
WARMUP eager steps on the side stream, then one graph a batch shape and
backend flags), each held against its eager body:
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
     with a planted NaN and int8 (f32 too at branch 0's input), in its
     transposing mode (NCHW input) and, for Cin % 16 == 0, its elementwise
     mode (the channels-last copy of the same input); then K2
     against its plain version, `torch.equal`, at every distinct quantized
     conv shape at that batch, float input with a planted NaN and int8
     input, dequantize and requant-relu epilogue, plus one dilated shape,
     each on the NCHW input and on its channels-last copy (the main path's
     layout: K2a's elementwise mode, none for an int8 input, and K2b's or
     the stem kernel's NHWC mode; torch.equal to the NCHW route on the whole
     batch, the output channels-last; a channels-last input of 8 channels,
     which no kernel takes, must raise):
     K2 (K2a + the implicit GEMM K2b, or the stem kernel for the stems'
     Cin of 3) runs on the whole batch, and its first and last 8 crops / 4
     images are held against the plain version on those images (the last
     ones sit at the largest offsets), the stems' whole outputs, 64 images
     a part; the stem kernel also at five small Cin-3 convs held whole
     (Cout 2, 8, 24, 40, 56, a W of 70, strides 1 and 2); then, on the
     channels-last input (the main path's layout) of the whole batch, the
     times of K2, K2a and K2b alone, K2 on an int8 input, K2b's
     requantizing mode on it (int8 in, int8 out) beside the K2b, E and K2a
     passes it replaces, the plain version and the bf16 cuDNN conv, for
     HRNet branch 0's 3x3 48->48 at 96x72 (x640) and YOLO's 3x3 128->256
     at 52x52 (x160), and of the stem kernel, the gather kernel (on the
     NCHW input, the only one it reads), the plain version and cuDNN at
     HRNet's stem 3x3 s2 3->64 at 384x288 (x640) and YOLO's 3x3 3->32 at
     416x416 (x160), each with its bound; K2a and K2 also at width-packed
     branch 0 (`ops.packing`: 3x3 96->96 at 96x36, x640, K = 864), checked
     as the main path's shapes and timed beside the unpacked branch 0,
     with the bf16 cuDNN conv's bound; K2b's halo path (`halo_path`, by
     shape): the checked launches that took it, K2b's ms on it and on the
     per-tap path (the rule forced either way), with a bf16 store and
     requantizing, and its bound at branch 0, branch 1 (3x3 96->96 at 48x36,
     x640) and YOLO's 3x3 128->256 (which the rule declines), and K2b
     forced onto it at
     HALO_EDGE_SHAPES, on an int8 input in every store mode, torch.equal to
     the plain version on the whole output;
  5. the main path at full width in bf16: `Pipeline.process_clip` with
     YOLOv3-416 (max_candidates=4) and HRNet-W48 384x288, random weights
     from a seed, BN folded into bf16 weights, 32-frame clips of 5 views of
     720x1280 uint8 frames; the decode launch count, K3's (one association
     and one init LAP a camera, a frame), the conv epilogue's (379 a clip,
     STEP_LAUNCHES), peak memory, host syncs; a forward pre-hook on every
     conv counts the inputs that are not channels-last (0 expected); and
     the layouts against each other on the first
     LAYOUT_FRAMES frames (`layout_agreement`): in f32 with TF32 off, the
     heatmaps and the detector's heads channels-last against the same
     models in NCHW (`nchw_model`) within LAYOUT_F32_REL in relative norm
     and equal detection masks; in bf16 the same numbers and the share of
     equal heatmap argmaxes, reported;
  6. the int8 main path: `Pipeline.quantize_models` on 8 frames of one view
     (on_drift="warn": random weights drift by design, so the self-check
     report is printed and not gated on), then `process_clip` twice on the
     same clip; K1, K2, K2a, stem-kernel, K2b-requantizing, K2b-halo and
     conv-epilogue launch counts (364 K2, 203 K2a, 2 stem, 159 requantizing,
     132 on the halo path and 204 epilogue per clip expected, STEP_LAUNCHES;
     every K2 and K2a launch in its channels-last mode),
     no NCHW conv input, peak memory, and the int8-vs-bf16 keypoint
     shift (for information); then every quantized conv on SUB_CROPS crops
     and SUB_IMAGES images, channels-last, torch.equal to the same conv on
     the NCHW copy of its input, and each of the 159 that requantize to the
     three passes they replace there (`int8_layouts_equal`);
  7. int8-resident blocks: one HRNet-W48 forward with `int8_resident=True`
     on 8 crops in f32, channels-last, each block held against the generic
     int8 block on the same input within the bound of the JAX package's
     test; K2's calls counted by input dtype and K2a's: none on an int8
     (channels-last) input, one on every float input but the stem's;
  8. the staged API: `process_frame` over the first 4 frames against
     `process_clip` on those frames one frame a clip, the same batch of
     views (equal masks, detections within atol 2e-2 / rtol 1e-3);
  9. the tracker on a synthetic scene with 5 views and 3 people: the same
     detections replayed through `person_track` on the card and on the CPU
     must give the same track ids, and 3 confirmed tracks; the card's track
     ids, states, hits, time since update and valid outputs must equal the
     port's f64 `OracleTracker` on the same detections at every frame, the
     last poses within 5e-3 m (tests/test_tracker_parity.py's rule); ms per
     frame, K3 launches and host syncs (the host detections' copies) per
     frame;
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
     (on_drift="warn"), each run with K1, K2, K2a, stem, requantizing and
     epilogue launches counted from 0 (6 x STEP_LAUNCHES: 6, 0, 0 in bf16;
     6, 6 x 364, 6 x 203 in int8) and K3 (68 x 6) and no NCHW
     conv input (the pre-hook of phase 5); each run's
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
     self-check; then `quantize_models(qat_steps=QAT_STEPS)` on fresh
     pipelines captured and eager (`disable_capture`), both under cuDNN
     deterministic: the same losses and int8 modules equal tensor for
     tensor, then eager without deterministic; ms per step of each and
     the 900 + 900-step start-up at each rate (`startup_900_s`); then
     one int8 `process_clip` (1 K1, 364 K2,
     203 K2a, 159 requantizing launches). Last, on the tiny configs in f32: the first QAT
     step's
     gradients of every fake-quant conv, card against CPU at the same
     input and output gradient, by relative norm (QAT_GRAD_LIMITS); then
     `distill_qat` for 3 steps on the card (capturable Adam, the third
     step a replay) and on the CPU (Adam) from the same weights and
     batches, held within Adam's bound (each step moves an entry by at
     most about lr), a sanity check;
 12. the CLI loop with tracks (`cli_tracks`): `run_eval_loop` fed the
     synthetic scene's detections (`synthetic_frame_source`, the
     `person_track` path) with Shelf's config's tracker capacities (16 /
     16 / 40), on the card and on the CPU: equal track ids and
     byte-equal per-camera JSONs, and confirmed tracks; ms per frame, host
     syncs and K3 launches per frame on the card.
 13. training (`train`) at full width: HRNet-W48 384x288 from a seed on blob
     batches of 8 (`models.train`), every step a captured CUDA graph after
     its key's 2 eager warm-ups: (a) `make_train_step` with
     `make_optimizer()` (capturable AdamW) in bf16, inference-mode BN, 20
     steps on one batch (ms per step, the median of steps 5-20, peak
     memory; the last loss must be below the first); (d) at step 10 the
     model and the optimizer are saved (`models.checkpoint`) and restored
     into fresh objects, every tensor torch.equal, and RESUME_STEPS more
     steps from each (cuDNN deterministic: a new key, and the fresh step
     captures over the restored tensors) compared by loss and gradient;
     (b) the JAX package's learning recipe, capturable Adam 1e-3 in f32
     with train-mode BN and a fresh batch per step, 20 steps (ms per step,
     peak memory, 4,000 steps extrapolated), then TF32_STEPS steps with
     TF32 on (a second key, a second capture); for (a) and (b) each key's
     graph nodes, capture seconds and pool, the host's µs for a replay
     and the card's ms for one, then the captured step against its eager
     body from the same weights on the same batches, both under cuDNN
     deterministic, every loss, trained tensor, `.grad` and optimizer
     state torch.equal, and the eager body alone for EAGER_STEPS steps
     (ms per step, peak); (c) on the tiny config, the first step's
     gradients of every trained tensor, BN statistics included, card
     against CPU in both BN modes (TRAIN_GRAD_LIMITS); (e) the tiny HRNet
     (weights from LEARN_SEED) trained on the card for 2,000 steps (1,998
     replays) to localize blobs with cuDNN deterministic, folded and
     decoded with K1
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
     through `quantize_convs` + `uncalibrated_scales`; K1 / K2 / K2a / K3 /
     conv epilogue launches counted from 0 (8, 0, 0, 768, 8 x 379 in bf16; 8,
     8 x 364, 8 x 203, 768, 8 x 204 in int8, 8 x 159 requantizing), no NCHW conv input, peak memory, host syncs; each stream's
     stage B equal to
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
     launches at the packed input in each; (a) and (b), inside phase 10 on
     its files and frames:
     `cli.convert.convert_checkpoints` writes a bf16 bundle, then an int8
     one quantized on the 8 calibration frames with on_drift="warn";
     `build_pipeline_real(bundle=...)` serves each with the checkpoint
     converters replaced by a function that fails; every tensor torch.equal
     to phase 10's pipeline (folded, or quantized in process); the CLI loop
     over the 68 frames gives phase 10's stage A detections (torch.equal),
     poses, launch counts and byte-equal per-camera JSONs (on random
     weights the tracker may confirm no track: the poses and JSONs are then
     empty on both sides); convert and load seconds, bundle MB.
 17. the frame loader from disk (`ingest`, `runtime.loader`,
     `runtime.ingest_bench`): (a) `fabricate_jpeg_dataset` writes 68 frames
     x 5 views of photo-like 720x1280 JPEGs at quality 90 (Pillow's 4:2:0
     chroma) and `fabricate_mini_dataset` 24 frames x 3 views of stick
     figures; every frame decoded with nvJPEG at each backend the card
     accepts against the Pillow plain version: mean, 99.9th percentile and
     max |difference| per channel, gated by DECODE_GATE (reported first, as
     the `ingest_decode` line); nvJPEG with 4 threads 8 frames ahead
     torch.equal, frame by frame, to one frame at a time; (b)
     `bench_decode`: the Pillow pool at 1, 2, 4, 8 threads, nvJPEG at each
     backend (2 threads) and the default backend at 4, sequential Pillow,
     the host's CPU count; (c)
     `bench_disk_to_device` through pinned memory (Pillow) and on the card
     (nvJPEG); (d) phase 10's Shelf config at MAX_CANDIDATES 4 and its
     checkpoint files in bf16 with ROOT at (a)'s folders: `run_eval_loop`
     over the frames decoded in (a) held in memory, then over
     `dataset_frame_source(cfg, True, timer, prefetch=32, device="cuda")`,
     K1 counted from 0 (6) and `loader.nvjpeg_images` (340); stage A's
     detections of every call and the harvested poses torch.equal between
     the two; ms per clip, decode_wait per frame after the first clip,
     decode_work, both loops' totals beside phase 10's.
 18. parallel across cards (`parallel`, `tpupose_torch.parallel.{mesh,
     multihost}`), after 14: the kernels built here, one spawned process
     per visible card (`multihost.initialize` over a `file://`
     rendezvous, NCCL; on one card a one-rank group of real NCCL calls);
     any rank's failure or PAR_TIMEOUT_S fails the run. (a)
     `make_sharded_train_step` on HRNet-W48 384x288 from a seed, phase 13
     (b)'s recipe (Adam 1e-3, f32, train-mode BN synchronized over 'data',
     targets x 10), cuDNN deterministic, PAR_TRAIN_BATCH crops per data
     rank, PAR_TRAIN_STEPS steps, at (data, model) = (2, 2) on four cards
     and (world, 1) otherwise. The step is one CUDA graph a key, its NCCL
     collectives inside (2 eager warm-ups, the capture, replays): its
     collectives by kind every step (one all-gather and one reduce-scatter
     a BN, the parameters' all-gather, the gradients' all-reduce; the first
     step adds the batch-size all-gather) and those its graph holds; then
     its eager body (`step.eager`) from the same weights on the same
     batches, torch.equal on every loss, local trained tensor, `.grad` and
     Adam state tensor of every step; every split tensor and its Adam
     moments hold 1 / model of the rows; the losses and the gathered
     parameters are held against rank 0's unsharded `make_train_step` on
     the whole global batch, graphed after its warm-ups as the sharded step
     is (PAR_LOSS_RTOL, PAR_PARAM_RTOL, PAR_PARAM_ATOL_LR), capturable Adam
     on both sides; graphed and eager: ms per step per rank (and rank 0's
     unsharded step's), capture seconds, pool MiB, graph nodes by type,
     host µs and device ms a replay, peak memory; parameter and Adam bytes
     held per rank, one small all-reduce's and all-gather's host µs, the
     NCCL version. (b) the multi-stream
     clip at (world, 1): YOLOv3-416 (max_candidates=4) and HRNet-W48 folded
     to bf16 and served channels-last (`to_channels_last`, as `Pipeline`
     serves), PAR_STREAMS_PER_CARD streams a card of PAR_FRAMES frames of 5
     random 720x1280 views, each stream's clip from its own seed; each rank
     makes only its own streams (`process_stream_slice`, `shard_streams`,
     `global_streams`), runs `make_multistream_clip_fn` once to warm up and
     once timed after a barrier, K1 and K3 counted from 0 (2 and 192 a
     rank), each stream's stage B equal to `track_clip` on its own stage-A
     detections; fps per rank and over all cards, the stage A / B split;
     `all_hosts_metric` of the active tracks equal on every rank and to the
     sum of the ranks' own counts; then the stage B alone through
     `make_multistream_step_fn(tcfg, mesh, num_streams)`, this rank's
     graph, to the clip function's final state.
 19. the tracker step as a captured CUDA graph (`graphs`,
     `runtime.graphs`): (a) at 4 / 12 / 24 and 16 / 16 / 40, GRAPH_FRAMES
     frames of a 5-view adversarial scene with a false positive a view and
     drops:
     `make_step_fn` frame by frame (frame ids as device tensors and as
     ints) and `track_clip` against the eager `tracker_step`,
     torch.equal on every state and output field of every frame (if not,
     the mismatches are reported and the discrete fields must still be
     equal, the poses within GRAPH_POSE_TOL); the graph's nodes by type
     (`cuGraphGetNodes`), capture seconds and pool bytes; (b)
     `make_multistream_step_fn` against the eager vmapped step at S = 1,
     8, 32 streams of different scenes and both capacity sets,
     GRAPH_MS_FRAMES frames twice (the first graphed run captures, the
     second replays), torch.equal on every field. Last, every tracker graph
     the run captured, with its replays (`graphs_captured`); then phase 13
     (f), `train_profile` (its profiles leave CUPTI attached, which slows
     every later launch on the host): for W48 recipes (a) and (b) one
     eager step and one replay under torch.profiler, kernels launched
     against the graph's kernel nodes, the device's busy ms and idle share.
 21. the conv epilogue (`epilogue`): the one-pass kernel of `ops.epilogue`
     bit for bit against its plain version at EPILOGUE_SHAPES, its ms
     beside its byte bound and the plain version's ms; as context, cuDNN's
     fused conv-bias-add-ReLU (`torch.cudnn_convolution_add_relu`, never
     called by the port) at branch 0's conv, its first call's seconds and
     its steady ms, against `F.conv2d` plus the kernel.
 22. ViTPose-H on the main path (`vitpose`), at `vitpose-h-clip32`'s
     shapes, YOLOv3-416 and ViTPose-H from a seed, BN folded (jittered),
     bf16: (a) the head's two transposed convs served by `deconv_out` on
     the backbone's features of 640 crops, each output channels-last and
     taken by the epilogue kernel, held bit for bit against the composed
     passes; (b) K1 at ViTPose's 640 x 17 x 64 x 48 maps, phase 3's
     comparison; (c) a 32-frame clip of 5 random 776x1032 views through
     `Pipeline.process_clip` (a warm-up clip first), the epilogue's, the
     fused attention's and K1's launches counted from 0 over one clip
     against VITPOSE_LAUNCHES, its outputs checked as phase 5's, its peak
     memory.
 23. HRFormer-B on the main path (`hrformer`), at `hrformer-b-clip32`'s
     shapes, YOLOv3-416 and HRFormer-B from a seed, BN folded (jittered),
     bf16: (a) the conv epilogue's GELU at branch 0's FFN over 640 crops,
     fc1's and dw3x3's bias + GELU (312 wide) and fc2's bias + GELU +
     residual (78 wide, the flat mode), each served by `conv_out` /
     `finish` and held bit for bit against the composed passes; (b) a
     32-frame clip of 5 random 776x1032 views through
     `Pipeline.process_clip` (a warm-up clip first), the epilogue's, the
     fused attention's and K1's launches counted from 0 over one clip
     against HRFORMER_LAUNCHES, its outputs checked as phase 5's, its peak
     memory.
With `--learned-seeds`, it builds the kernels and runs only phase 13 (e)
for each seed given, reporting the errors without gating on them (the
K2-against-plain check still fails the run). With `--only k2 k3`, it builds
the kernels and runs only phase 4 (k2) and phase 15 (a) (k3); with
`--only ingest`, phase 17, its checkpoint files written anew from phase
10's seed; with `--only parallel`, phase 18; with `--only graphs`, phase 19;
with `--only train`, phase 13 and then 13 (f); with `--only epilogue`,
phase 21; with `--only vitpose`, phase 22; with `--only hrformer`, phase 23.
It prints a JSON line per phase, then `{"kernels": [...]}` (with each
kernel's launches in phase 10 as `cli_launches`, in phase 15 (d) as
`multistream_launches`, K1's in phase 14 as `e2e_launches`, K2's and
K2a's in phase 13 (e) as `learned_int8_launches`, K2's in phase 16 (b)'s
bundle loop as `bundle_launches`, K1's and K3's in phase 17 (d)'s loop
from disk as `ingest_launches`, K1's and K3's per rank in phase 18 (b) as
`parallel_launches_per_rank`; K2's `packed_branch0` holds phase 4's
times and bounds at the packed branch-0 shape beside the unpacked one's
and phase 16 (c)'s K2 launches at that shape a packed clip; K2's `halo` holds
K2b's halo path: phase 6's, 10's and 15 (d)'s launches on it, phase 4's
checked launches and edge checks, and its rows at branch 0, branch 1 and
YOLO's 3x3 128->256 (`halo_row`); the stem kernel's row
times HRNet's stem and, under `yolo_stem`, YOLO's; K2's, K2a's and the
stem kernel's `ms` and `plain_ms` are their channels-last modes' (the main
path's); K3's `launches` are
phase 15 (d)'s int8 run's, and its times those of (a) at (d)'s
association shape, with `device_us`, `host_us` and `op_host_us`; its
`bound_ms` is the latency bound, `bound_by` "latency", and the
bytes-or-operations bound of the other rows stands beside it as
`rate_bound_ms`; `in_graphs` its launches held per replay and replayed
in this process's graphs; the conv epilogue's `launches` are phase 5's two
bf16 clips', `int8_clip_launches` phase 6's two int8 clips', and
`packed_launches` phase 16 (c)'s packed clip's, each held against
STEP_LAUNCHES, and its times are phase 21's; K1's and the epilogue's
launches in phase 22 (c)'s ViTPose-H clip as `vitpose_launches`, held
against VITPOSE_LAUNCHES, and in phase 23 (b)'s HRFormer-B clip as
`hrformer_launches`, held against HRFORMER_LAUNCHES), the nvidia-smi line, and last `{"ok": true,
"device": {...}}`. It needs a CUDA card and the repository around it;
without either it exits non-zero and prints no result. The f32
comparisons run with TF32 off (so do phase 11's f32 fake-quant
convolutions and phase 13's f32 training, but for the 6 steps that say
so).
"""
from __future__ import annotations

import contextlib
import copy
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
#: HRNet-W48's branch-1 3x3 conv, 96->96 at 48x36 (phase 4's halo rows).
BRANCH1 = (96, 48, 36, 96, 3, 1, 1)
#: K2b's halo path forced at shapes off the main path, held whole against
#: plain in phase 4 (`halo_edges`): (Cin, H, W, Cout) with Cin 16 and 256,
#: images smaller than a patch, H and W that no patch divides, a Cout past
#: one channel tile and no multiple of 16.
HALO_EDGE_SHAPES = ((16, 20, 30, 24), (32, 5, 3, 40), (48, 37, 23, 80), (16, 1, 1, 16),
                    (256, 13, 13, 48), (64, 9, 200, 72))
HALO_EDGE_BATCH = 3

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


@contextlib.contextmanager
def nchw_conv_inputs(torch, *models):
    """Counts the conv inputs of `models` (float and int8 convs) that are not
    channels-last, by a forward pre-hook on every conv, while the block runs.
    Yields a dict whose "nchw" and "convs" grow as the convs run."""
    from tpupose_torch.models.layers import QuantConv2d

    counts = {"nchw": 0, "convs": 0}

    def hook(mod, args):
        counts["convs"] += 1
        counts["nchw"] += not args[0].is_contiguous(memory_format=torch.channels_last)

    hooks = [m.register_forward_pre_hook(hook) for model in models for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, QuantConv2d))]
    try:
        yield counts
    finally:
        for h in hooks:
            h.remove()


def check_channels_last(counts, what):
    """Fails unless convs ran and none of their inputs was NCHW."""
    if not counts["convs"] or counts["nchw"]:
        fail(f"{what}: {counts['nchw']} of {counts['convs']} conv inputs were not "
             f"channels-last")
    return counts


def nchw_model(torch, model):
    """A copy of `model` with NCHW weights that runs on an NCHW copy of its
    input: the port's stage A as it was before it served channels-last
    (`_pose_crops` and `detect_people` copied the networks' inputs to NCHW),
    for the layout comparisons."""
    class NCHW(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = copy.deepcopy(model).to(memory_format=torch.contiguous_format)

        def forward(self, x, *args):
            return self.model(x.contiguous(), *args)

    return NCHW()


def phase_kernel(th, torch, gen, shape=(640, 17, 96, 72)):
    n, j, h, w = shape
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
    branch 0's input, packed and not; in both modes where Cin % 16 == 0
    (the transposing one on the NCHW input, the elementwise one on its
    channels-last copy), the first mode alone at the stems' Cin of 3."""
    from tpupose_torch.ops import int8_conv as k2

    inv = torch.tensor([127.0 / 8.0], device="cuda")
    inputs = sorted({(sh[:3], MAIN_CROPS) for sh in hr_shapes}
                    | {(BRANCH0_PACKED[:3], MAIN_CROPS)}
                    | {(sh[:3], MAIN_IMAGES) for sh in yo_shapes})
    checked = checked_cl = 0
    for shape, batch in inputs:
        dtypes = [torch.bfloat16, torch.int8]
        if shape in (BRANCH0[:3], BRANCH0_PACKED[:3]):
            dtypes.append(torch.float32)
        for dtype in dtypes:
            x = k2a_input(torch, gen, shape, batch, dtype)
            ref = k2.quantize_nhwc_plain(x, inv)
            layouts = [x] + ([x.contiguous(memory_format=torch.channels_last)]
                             if k2.channels_last(shape[0]) else [])
            for xl in layouts:
                before = k2.quantize_cl_launches
                got = k2.quantize_nhwc_cuda(xl, inv)
                mode = "channels-last" if k2.quantize_cl_launches > before else "NCHW"
                if (mode == "channels-last") != (xl is not x):
                    fail(f"K2a {shape} {dtype}: the {mode} mode ran on the other layout")
                if not torch.equal(got, ref):
                    fail(f"K2a ({mode}) {shape} batch {batch} {dtype}: differs from the plain "
                         f"version in {int((got != ref).sum())} codes")
                if dtype != torch.int8 and got[0, shape[1] // 2, shape[2] // 2, 0] != 0:
                    fail(f"K2a ({mode}) {shape} {dtype}: the planted NaN did not quantize to 0")
                checked += 1
                checked_cl += xl is not x
                del got
            del x, ref, layouts
    return {"checked": checked, "checked_channels_last": checked_cl,
            "distinct_inputs": len(inputs), "max_abs_err": 0.0}


@contextlib.contextmanager
def halo_rule(k2, take):
    """K2b's halo path taken (`take`) or declined at every shape, in place
    of its shape rule: to time the per-tap path where the rule takes the
    halo, and to check the halo path where the rule declines it."""
    rule = k2.halo_path
    k2.halo_path = lambda *args: take
    try:
        yield
    finally:
        k2.halo_path = rule


def halo_edges(torch, gen):
    """K2b on its halo path (the shape rule forced) at HALO_EDGE_SHAPES, on
    an int8 channels-last input, in every store mode (NHWC and NCHW f32,
    bf16 and int8 requant-relu; the requantizing mode through bf16 with
    ReLU and f32 with leaky ReLU), each launch on the halo path and its
    whole output `torch.equal` to the plain version."""
    from tpupose_torch.ops import int8_conv as k2

    b16, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    inv_next = torch.tensor([127.0 / 4.0], device="cuda")
    checked = 0
    with halo_rule(k2, True):
        for cin, h, w, cout in HALO_EDGE_SHAPES:
            for out_dtype, nhwc, requant in [(b16, True, None), (f32, True, None),
                                             (i8, True, (b16, "relu")), (i8, True, (f32, "leaky")),
                                             (b16, False, None), (f32, False, None),
                                             (i8, False, None)]:
                gain = 120.0 if out_dtype == i8 else 40.0
                wq, wk, x, _, mul, add = k2_operands(torch, k2, gen, (cin, h, w, cout, 3, 1, 1),
                                                     HALO_EDGE_BATCH, i8, out_dtype, gain)
                xi = x.contiguous(memory_format=torch.channels_last)
                before = k2.halo_launches
                got = k2.gemm_nhwc_cuda(xi.permute(0, 2, 3, 1), wk, (3, 3), mul, add, out_dtype,
                                        nhwc_out=nhwc,
                                        requant=None if requant is None else (*requant, inv_next))
                if k2.halo_launches != before + 1:
                    fail(f"K2b halo edge {(cin, h, w, cout)}: not launched on the halo path")
                if requant is None:
                    ref = k2.int8_conv_plain(xi, wq, None, mul, add, out_dtype)
                else:
                    ref = k2.int8_conv_requant_plain(xi, wq, None, mul, add, *requant, inv_next)
                if not torch.equal(got, ref):
                    fail(f"K2b halo edge {(cin, h, w, cout)} -> {out_dtype} nhwc={nhwc} "
                         f"requant={requant}: {int((got != ref).sum())} outputs differ from "
                         f"the plain version")
                checked += 1
    return {"shapes": [list(sh) for sh in HALO_EDGE_SHAPES], "batch": HALO_EDGE_BATCH,
            "checked": checked, "max_abs_err": 0.0}


def halo_row(timed):
    """The kernels line's row of K2b's two paths at one of time_k2's 3x3
    stride-1 shapes: whether the rule takes the halo path there, the halo
    path's and the per-tap path's ms against the bound, with a bf16 store
    and requantizing, and the A bytes a block copies a pixel."""
    return {"shape": timed["shape"], "halo_path": timed["halo_path"],
            "halo_tile": timed["halo_tile"], "a_bytes_per_pixel": timed["a_bytes_per_pixel"],
            **{f"{mode}_{f}": timed[mode][f] for mode in ("k2b", "k2b_requant")
               for f in ("halo_ms", "per_tap_ms", "bound_ms", "bound_by")}}


def time_k2(torch, gen, shape, batch):
    """Times of one conv shape at `batch`, bf16 in and out, on a
    channels-last input (the main path's layout): K2 as the main path
    calls it, and, on the GEMM path, K2a and K2b alone, K2 on an int8
    channels-last input (K2b alone, the int8-resident blocks' route) and
    K2b's requantizing mode on it (beside the K2b, E and K2a passes it
    replaces); on the stems' route, the gather kernel on the NCHW input,
    the only layout it reads; the plain version and the bf16 cuDNN conv;
    each kernel with its bound."""
    import torch.nn.functional as F

    from tpupose_torch.ops import epilogue
    from tpupose_torch.ops import int8_conv as k2

    b16, cl = torch.bfloat16, torch.channels_last
    cin, h, w, cout, k, stride, dil = shape
    wq, wk, x, inv, mul, add = k2_operands(torch, k2, gen, shape, batch, b16, b16)
    xc = x.contiguous(memory_format=cl)
    y = k2.int8_conv_cuda(xc, wk, (k, k), inv, mul, add, b16, stride, dil)
    vectors = 2 * cout * 4 + 4
    ops = 2 * y.numel() * cin * k * k
    out = {"shape": [batch, cin, h, w, cout, k, stride],
           "ms": cuda_time_ms(lambda: k2.int8_conv_cuda(xc, wk, (k, k), inv, mul, add, b16,
                                                        stride, dil), reps=10),
           **bound(x.numel() * 2 + wq.numel() + y.numel() * 2 + vectors, ops,
                   H100_INT8_OPS_PER_S)}
    if k2.channels_last(cin):
        xq = k2.quantize_nhwc_cuda(xc, inv)
        out["k2a"] = {"ms": cuda_time_ms(lambda: k2.quantize_nhwc_cuda(xc, inv), reps=10),
                      "plain_ms": cuda_time_ms(lambda: k2.quantize_nhwc_plain(xc, inv),
                                               warmup=1, reps=5),
                      **bound(x.numel() * 2 + xq.numel(), 4 * x.numel(), H100_F32_OPS_PER_S)}
        out["k2b"] = {"ms": cuda_time_ms(lambda: k2.gemm_nhwc_cuda(
                          xq, wk, (k, k), mul, add, b16, stride, dil, nhwc_out=True), reps=10),
                      **bound(xq.numel() + wq.numel() + y.numel() * 2 + vectors, ops,
                              H100_INT8_OPS_PER_S)}
        out["halo_path"] = k2.halo_path(cin, k, k, stride, dil, h, w)
        # both K2b paths where the halo path can run: 3x3, stride 1
        paths = {"halo_ms": True, "per_tap_ms": False} if k == 3 and stride == dil == 1 else {}
        if paths:
            th_, tw_ = k2.halo_tile(h, w)
            # A bytes a block copies from L2 into shared memory per output pixel
            out["a_bytes_per_pixel"] = {"per_tap": k * k * cin,
                                        "halo": (th_ + 2) * (tw_ + 2) * cin / (th_ * tw_)}
            out["halo_tile"] = [th_, tw_]
        for name, take in paths.items():
            with halo_rule(k2, take):
                out["k2b"][name] = cuda_time_ms(lambda: k2.gemm_nhwc_cuda(
                    xq, wk, (k, k), mul, add, b16, stride, dil, nhwc_out=True), reps=10)
        out["design_bytes"] = out["k2a"]["bytes"] + out["k2b"]["bytes"]
        out["design_bound_ms"] = out["design_bytes"] / H100_BYTES_PER_S * 1e3
        # an int8 channels-last input: K2b reads it in place, no K2a
        xi = xq.permute(0, 3, 1, 2)
        before = k2.quantize_launches
        out["int8_input"] = {"ms": cuda_time_ms(lambda: k2.int8_conv_cuda(
                                 xi, wk, (k, k), None, mul, add, b16, stride, dil), reps=10),
                             **{f: out["k2b"][f] for f in ("bound_ms", "bound_by", "bytes",
                                                           "ops")}}
        out["int8_input"]["k2a_launches"] = k2.quantize_launches - before
        if out["int8_input"]["k2a_launches"]:
            fail(f"K2 on an int8 channels-last input {shape} launched K2a")
        # K2b's requantizing mode on that int8 input, which reads int8 and
        # writes the next conv's int8 input, against the three passes it
        # takes the place of: K2b's bf16 store, E's ReLU, K2a
        inv_next = torch.tensor([127.0 / 8.0], device="cuda")
        out["k2b_requant"] = {
            "ms": cuda_time_ms(lambda: k2.int8_conv_requant_cuda(
                xi, wk, (k, k), None, mul, add, b16, "relu", inv_next, stride, dil), reps=10),
            **bound(xq.numel() + wq.numel() + y.numel() + vectors + 4, ops,
                    H100_INT8_OPS_PER_S)}

        def three_passes():
            z = k2.int8_conv_cuda(xi, wk, (k, k), None, mul, add, b16, stride, dil)
            return k2.quantize_nhwc_cuda(epilogue.bias_act_cuda(z, act="relu"), inv_next)

        out["k2b_requant"]["three_passes_ms"] = cuda_time_ms(three_passes, reps=10)
        for name, take in paths.items():
            with halo_rule(k2, take):
                out["k2b_requant"][name] = cuda_time_ms(
                    lambda: k2.int8_conv_requant_cuda(xi, wk, (k, k), None, mul, add, b16,
                                                      "relu", inv_next, stride, dil), reps=10)
        del xq, xi
    if k2.stem_path(cin, k, k):  # the stems' route before the stem kernel
        out["gather_ms"] = cuda_time_ms(lambda: k2.gather_conv_cuda(
            x, wk, (k, k), inv, mul, add, b16, stride, dil), reps=10)
    out["plain_ms"] = cuda_time_ms(
        lambda: k2.int8_conv_plain(xc, wq, inv, mul, add, b16, stride, dil), warmup=1, reps=3)
    wb = torch.randn((cout, cin, k, k), generator=gen, device="cuda").to(b16)
    wbc = wb.contiguous(memory_format=cl)
    out["bf16_cudnn_ms"] = cuda_time_ms(
        lambda: F.conv2d(xc, wbc, stride=stride, padding=k // 2, dilation=dil), reps=10)
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
    checked_cl, halo0 = 0, k2.halo_launches
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
            # the channels-last route: K2a's elementwise mode (none for an
            # int8 input) and K2b's NHWC store, or the stem kernel's
            xc = x.contiguous(memory_format=torch.channels_last)
            counts = (k2.quantize_launches, k2.nhwc_launches)
            got_cl = k2.int8_conv_cuda(xc, wk, (k, k), inv, mul, add, out_dtype, stride, dil)
            k2a_runs = k2.quantize_launches - counts[0]
            if (k2a_runs, k2.nhwc_launches - counts[1]) != (
                    int(k2.channels_last(cin) and in_dtype != i8), 1):
                fail(f"{what}, channels-last: {k2a_runs} K2a and "
                     f"{k2.nhwc_launches - counts[1]} NHWC-output launches")
            if not got_cl.is_contiguous(memory_format=torch.channels_last):
                fail(f"{what}: the channels-last route's output is not channels-last")
            if not torch.equal(got_cl, got):
                fail(f"{what}: the channels-last route differs from the NCHW route in "
                     f"{int((got_cl != got).sum())} outputs")
            if out_dtype != i8 and not bool(torch.isfinite(got).all()):
                fail(f"{what}: non-finite outputs")
            for first, size in parts:
                part = slice(first, first + size)
                ref = k2.int8_conv_plain(x[part], wq, inv, mul, add, out_dtype, stride, dil)
                err = float((got[part].float() - ref.float()).abs().max())
                max_err = max(max_err, err)
                if stem:
                    stem_err = max(stem_err, err)
                for route, y in (("NCHW", got), ("channels-last", got_cl)):
                    if not torch.equal(y[part], ref):
                        fail(f"{what} ({route}): images {first}..{first + size - 1} differ "
                             f"from the plain version by up to "
                             f"{float((y[part].float() - ref.float()).abs().max())}")
                if out_dtype == i8 and not (ref.min() == 0 and ref.max() == 127):
                    fail(f"{what}: the requant check does not span [0, 127]")
                del ref
            checked += 1
            checked_cl += 1
            stems += stem
            gathered += not (stem or k2.channels_last(cin))
            del x, xc, got, got_cl
    on_halo_path = k2.halo_launches - halo0
    edges = halo_edges(torch, gen)
    # the gather kernel reads NCHW only: a channels-last input is refused
    wq, wk, x, inv, mul, add = k2_operands(torch, k2, gen, (8, 12, 10, 16, 3, 1, 1), 2,
                                           b16, b16)
    try:
        k2.int8_conv_cuda(x.contiguous(memory_format=torch.channels_last), wk, (3, 3), inv,
                          mul, add, b16)
        fail("K2: a channels-last input of 8 channels was not refused")
    except ValueError:
        pass
    timed = {name: time_k2(torch, gen, shape, batch)
             for name, shape, batch in (
                 ("hrnet_branch0_3x3_48", BRANCH0, MAIN_CROPS),
                 ("hrnet_branch1_3x3_96", BRANCH1, MAIN_CROPS),
                 ("hrnet_branch0_packed_3x3_96", BRANCH0_PACKED, MAIN_CROPS),
                 ("yolo_3x3_128_256", (128, 52, 52, 256, 3, 1, 1), MAIN_IMAGES),
                 ("hrnet_stem_3x3_s2_3_64", (3, 384, 288, 64, 3, 2, 1), MAIN_CROPS),
                 ("yolo_stem_3x3_3_32", (3, 416, 416, 32, 3, 1, 1), MAIN_IMAGES))}
    return {"card": card, "checked": checked, "checked_channels_last": checked_cl,
            "checked_on_stem_kernel": stems,
            "checked_on_gather_path": gathered, "stem_max_abs_err": stem_err,
            "k2b_launches_on_halo_path": on_halo_path, "halo_edges": edges,
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
    from tpupose_torch.ops import epilogue
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import lap
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking.tracker import TrackerConfig

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
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()

    # the main path: counts from 0, two clips, counts read right after
    torch.cuda.reset_peak_memory_stats()
    th.launches = 0
    lap.launches = 0
    epilogue.launches = 0
    replays = card_replays()
    syncs = 0
    with nchw_conv_inputs(torch, pipe.detector, pipe.pose_model) as layouts:
        for _ in range(2):
            with counted_syncs() as counted:
                outs, dets, mask = pipe.process_clip(frame_ids, clip)
            torch.cuda.synchronize()
            syncs += counted["syncs"]
    launches, k3_launches, epi_launches = th.launches, lap.launches, epilogue.launches
    replays = card_replays() - replays
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches < 1:
        fail("the main path never launched the heatmap decode kernel")
    if epi_launches != 2 * STEP_LAUNCHES["bf16"]["epilogue.launches"]:
        fail(f"two clips launched the conv epilogue {epi_launches} times, expected "
             f"{2 * STEP_LAUNCHES['bf16']['epilogue.launches']}")
    if replays != 2 * frames:
        fail(f"two clips replayed the tracker's graph {replays} times, expected {2 * frames}")
    if k3_launches != 2 * frames * (1 + views):
        fail(f"two clips launched K3 {k3_launches} times, expected "
             f"{2 * frames * (1 + views)} (one association and {views} init LAPs a frame)")

    check_clip_outputs(torch, outs, dets, mask, frames, views, tcfg)
    check_channels_last(layouts, "bf16 clip path")
    return {
        "config": "YOLOv3-416 (max_candidates=4) + HRNet-W48 384x288, BN folded, "
                  "bf16; 32 frames x 5 views x 720x1280 uint8",
        "card": card, "conv_inputs": layouts, "layouts": layout_agreement(torch, pipe, clip),
        "decode_launches": launches, "k3_launches": k3_launches,
        "epilogue_launches": epi_launches, "clips": 2, "graph_replays": replays,
        "host_syncs_per_frame": syncs / (2 * frames),
        "detections_valid": int(mask.sum()), "peak_mem_gib": peak_gib,
    }, (pipe, clip, frame_ids, dets, mask)


LAYOUT_FRAMES = 2  # frames of the clip (x 5 views) for the layout comparisons
#: The layout comparisons in f32, TF32 off: channels-last against NCHW
#: heatmaps and detector heads within this relative norm (summation order
#: only), and equal detection masks.
LAYOUT_F32_REL = 1e-5


def layout_agreement(torch, pipe, clip):
    """The served channels-last stage A against the same models in NCHW
    (`nchw_model`) on the first LAYOUT_FRAMES frames: in f32 (copies of the
    bf16 weights cast to f32, TF32 off) the heatmaps on the channels-last
    run's crops and the detector's heads within LAYOUT_F32_REL in relative
    norm, and `_clip_detections`' masks equal (gates); in bf16 the same
    quantities and the share of heatmap planes whose argmax agrees,
    reported as phase 16 (c) reports packing's."""
    from tpupose_torch.models.yolov3 import prepare_yolo_images
    from tpupose_torch.pipeline.facade import _clip_detections, _pose_crops

    images = clip[:LAYOUT_FRAMES].reshape(-1, *clip.shape[2:])
    xf = images.to(torch.bfloat16) / 255.0
    out = {"images": images.shape[0]}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        det, pose = ((copy.deepcopy(pipe.detector).float(), copy.deepcopy(pipe.pose_model).float())
                     if dtype == torch.float32 else (pipe.detector, pipe.pose_model))
        det_n, pose_n = nchw_model(torch, det), nchw_model(torch, pose)
        with torch.inference_mode():
            runs = [_clip_detections(pipe.det_cfg, pipe.pose_cfg, pipe.tracker_cfg, d, p,
                                     images, dtype) for d, p in ((det, pose), (det_n, pose_n))]
            ximg = prepare_yolo_images(pipe.det_cfg, xf).permute(0, 3, 1, 2)
            heads = [det(ximg, dtype), det_n(ximg, dtype)]
            boxes, _, _ = pipe.person_detect(images)
            _, crops = _pose_crops(pipe.pose_cfg, xf, boxes)
            heat, heat_n = pose(crops, dtype), pose_n(crops, dtype)
        row = {"crops": crops.shape[0],
               "heatmaps_rel": rel_norm(torch, {0: heat.float()}, {0: heat_n.float()}),
               "heads_rel": [rel_norm(torch, {0: a.float()}, {0: b.float()})
                             for a, b in zip(*heads)],
               "masks_equal": bool(torch.equal(runs[0][1], runs[1][1])),
               "detections_valid": int(runs[0][1].sum()),
               "argmax_equal_share": float((heat.flatten(2).argmax(-1)
                                            == heat_n.flatten(2).argmax(-1)).float().mean())}
        if not (heat.is_contiguous(memory_format=torch.channels_last) and heat_n.is_contiguous()):
            fail(f"layouts ({name}): the heatmaps are not in their input's layout")
        if dtype == torch.float32:
            worst = max([row["heatmaps_rel"]] + row["heads_rel"])
            if worst > LAYOUT_F32_REL or not row["masks_equal"]:
                fail(f"layouts in f32: channels-last against NCHW {row}, gates: relative "
                     f"norm {LAYOUT_F32_REL}, equal masks")
        out[name] = row
        del det, pose, det_n, pose_n, runs, heads, heat, heat_n
    return out


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

    from tpupose_torch.ops import epilogue
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2
    from tpupose_torch.ops import lap

    pipe, clip, frame_ids, dets_bf16, mask_bf16 = main
    frames, views = clip.shape[0], clip.shape[1]
    tcfg = pipe.tracker_cfg
    log = io.StringIO()
    with redirect_stdout(log):
        # random weights drift by design: report the check, do not gate on it
        pipe.quantize_models(clip[:8, 0].contiguous(), on_drift="warn")
    print(log.getvalue().rstrip(), flush=True)
    report = dict(pipe.last_quant_report)
    pipe.track_restart()
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()

    # the int8 main path: counts from 0, two clips, counts read right after
    torch.cuda.reset_peak_memory_stats()
    th.launches = 0
    k2.launches = 0
    k2.quantize_launches = k2.quantize_cl_launches = 0
    k2.stem_launches = k2.nhwc_launches = k2.requant_launches = k2.halo_launches = 0
    lap.launches = 0
    epilogue.launches = 0
    replays = card_replays()
    syncs = 0
    with nchw_conv_inputs(torch, pipe.detector, pipe.pose_model) as layouts:
        for _ in range(2):
            with counted_syncs() as counted:
                outs, dets, mask = pipe.process_clip(frame_ids, clip)
            torch.cuda.synchronize()
            syncs += counted["syncs"]
    k1_launches, k2_launches, k3_launches = th.launches, k2.launches, lap.launches
    k2a_launches, stem_launches = k2.quantize_launches, k2.stem_launches
    k2a_cl_launches, nhwc_launches = k2.quantize_cl_launches, k2.nhwc_launches
    requant_launches, halo_launches = k2.requant_launches, k2.halo_launches
    epi_launches = epilogue.launches
    check_channels_last(layouts, "int8 clip path")
    if epi_launches != 2 * STEP_LAUNCHES["int8"]["epilogue.launches"]:
        fail(f"two int8 clips launched the conv epilogue {epi_launches} times, expected "
             f"{2 * STEP_LAUNCHES['int8']['epilogue.launches']}")
    if (k2a_cl_launches, nhwc_launches) != (k2a_launches, k2_launches):
        fail(f"two int8 clips: {k2a_cl_launches} of {k2a_launches} K2a launches in the "
             f"channels-last mode and {nhwc_launches} of {k2_launches} K2 launches with an "
             f"NHWC store, expected all")
    replays = card_replays() - replays
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if (k3_launches, replays) != (2 * frames * (1 + views), 2 * frames):
        fail(f"two int8 clips launched K3 {k3_launches} times in {replays} graph replays, "
             f"expected {2 * frames * (1 + views)} in {2 * frames}")
    expect = STEP_LAUNCHES["int8"]
    expect = tuple(2 * expect[f"int8_conv.{k}"] for k in (
        "launches", "quantize_launches", "stem_launches", "requant_launches", "halo_launches"))
    if k1_launches < 1 or (k2_launches, k2a_launches, stem_launches,
                           requant_launches, halo_launches) != expect:
        fail(f"two int8 clips launched K1 {k1_launches}, K2 {k2_launches}, K2a "
             f"{k2a_launches}, the stem kernel {stem_launches}, K2b requantizing "
             f"{requant_launches} and K2b on the halo path {halo_launches} times, expected "
             f">= 1 and {expect}")
    check_clip_outputs(torch, outs, dets, mask, frames, views, tcfg)
    layouts_int8 = int8_layouts_equal(torch, pipe, clip)
    both = (mask & mask_bf16)
    shift = torch.linalg.norm(dets[..., :2] - dets_bf16[..., :2], dim=-1)[both]
    return {
        "config": "the main path's pipeline after quantize_models (int8 YOLOv3-416 and "
                  "HRNet-W48 through K2, float heads)",
        "card": card, "self_check": report,
        "k2_launches": k2_launches, "k2_launches_per_clip": k2_launches / 2,
        "quantize_launches": k2a_launches, "quantize_launches_per_clip": k2a_launches / 2,
        "stem_launches": stem_launches, "epilogue_launches": epi_launches,
        "requant_launches": requant_launches, "halo_launches": halo_launches,
        "k1_launches": k1_launches, "k3_launches": k3_launches, "clips": 2,
        "graph_replays": replays,
        "quantize_cl_launches": k2a_cl_launches, "nhwc_launches": nhwc_launches,
        "conv_inputs": layouts, "layouts": layouts_int8,
        "host_syncs_per_frame": syncs / (2 * frames),
        "detections_valid": int(mask.sum()), "masks_equal_bf16": bool(torch.equal(mask, mask_bf16)),
        "kps_shift_vs_bf16_px": {"median": float(shift.median()), "p95": float(shift.quantile(0.95)),
                                 "max": float(shift.max()), "n": int(shift.numel())},
        "peak_mem_gib": peak_gib,
    }


def k2_launches_at(torch, pipe, clip, shape):
    """K2 launches in one int8 stage A whose input is of (C, H, W) `shape`."""
    from tpupose_torch.ops import int8_conv as k2

    names = ("int8_conv_cuda", "int8_conv_requant_cuda")
    inner = {fn: getattr(k2, fn) for fn in names}
    at_shape = [0]

    def counted(fn):
        def run(*args, **kw):
            at_shape[0] += tuple(args[0].shape[1:]) == shape
            return inner[fn](*args, **kw)
        return run

    for fn in names:
        setattr(k2, fn, counted(fn))
    try:
        pipe.process_clip_nn(clip)
    finally:
        for fn in names:
            setattr(k2, fn, inner[fn])
    return at_shape[0]


def int8_layouts_equal(torch, pipe, clip):
    """Every quantized conv of the int8 models on SUB_CROPS crops and
    SUB_IMAGES images of the clip's first frame, channels-last as served,
    torch.equal to the same conv on the NCHW copy of its input (K2's NCHW
    routes), its output channels-last; a conv that writes the next one's
    int8 input (K2b's requantizing mode, which has no NCHW route) to the
    three steps it replaces there: K2 to the intermediate's dtype, the
    activation's plain ops, the next conv's quantization."""
    from tpupose_torch.models import layers
    from tpupose_torch.models.layers import QuantConv2d
    from tpupose_torch.models.yolov3 import prepare_yolo_images
    from tpupose_torch.ops.epilogue import bias_act_plain
    from tpupose_torch.ops.int8_conv import int8_conv, quantize_input
    from tpupose_torch.pipeline.facade import _pose_crops

    checked = {"hrnet": 0, "yolo": 0, "requantizing": 0}
    inner = layers.int8_conv_requant

    def requant(x, weight_q, weight_k, inv, mul, add, mid, act, inv_next, stride=1,
                dilation=1):
        out = inner(x, weight_q, weight_k, inv, mul, add, mid, act, inv_next, stride, dilation)
        y = int8_conv(x.contiguous(), weight_q, weight_k, inv, mul, add, mid, stride, dilation)
        ref = quantize_input(bias_act_plain(y, act=act), inv_next)
        if not out.is_contiguous(memory_format=torch.channels_last):
            fail("int8 layouts: a requantizing conv's output is not channels-last")
        if not torch.equal(out, ref):
            fail(f"int8 layouts: a requantizing conv {tuple(x.shape)} differs from the NCHW "
                 f"steps in {int((out != ref).sum())} codes")
        checked["requantizing"] += 1
        return out

    def hook(name):
        def check(mod, args, out):
            x = args[0]
            ref = int8_conv(x.contiguous(), mod.weight_q, mod.weight_k, mod.inv_scale(),
                            *mod.dequant_vectors(), out.dtype, mod.stride, mod.dilation)
            if not out.is_contiguous(memory_format=torch.channels_last):
                fail(f"int8 layouts: a {name} conv's output is not channels-last")
            if not torch.equal(out, ref):
                fail(f"int8 layouts: a {name} conv {tuple(x.shape)} differs channels-last "
                     f"from NCHW in {int((out != ref).sum())} outputs")
            checked[name] += 1
        return check

    with torch.inference_mode():
        xf = clip[0].to(torch.bfloat16) / 255.0
        ximg = prepare_yolo_images(pipe.det_cfg, xf)[:SUB_IMAGES]
        boxes, _, _ = pipe.person_detect(clip[0])
        _, crops = _pose_crops(pipe.pose_cfg, xf, boxes)
    hooks = [m.register_forward_hook(hook(name))
             for name, model in (("hrnet", pipe.pose_model), ("yolo", pipe.detector))
             for m in model.modules() if isinstance(m, QuantConv2d)]
    layers.int8_conv_requant = requant
    try:
        with torch.inference_mode():
            pipe.detector(ximg.permute(0, 3, 1, 2), pipe.compute_dtype)
            pipe.pose_model(crops[:SUB_CROPS], pipe.compute_dtype)
    finally:
        layers.int8_conv_requant = inner
        for h in hooks:
            h.remove()
    # the requantizing convs run no forward of their own (no hook)
    expect = (292 - 124, 72 - 35, REQUANT_PAIRS)
    if (checked["hrnet"], checked["yolo"], checked["requantizing"]) != expect:
        fail(f"int8 layouts: {checked} quantized convs checked, expected {expect}")
    return {"crops": SUB_CROPS, "images": SUB_IMAGES, "convs_equal": checked}


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
    from tpupose_torch.ops import int8_conv as k2
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
    # the resident forward's K2 calls by input dtype (the fuse chains'
    # requantizing convs among them), and the K2a passes
    calls, inner = {"int8": 0, "float": 0, "k2a": 0, "k2a_on_int8": 0}, k2.int8_conv_cuda
    inner_k2a, inner_requant = k2.quantize_nhwc_cuda, k2.int8_conv_requant_cuda

    def counted(*args, **kw):
        calls["int8" if args[0].dtype == torch.int8 else "float"] += 1
        return inner(*args, **kw)

    def counted_requant(*args, **kw):
        calls["int8" if args[0].dtype == torch.int8 else "float"] += 1
        return inner_requant(*args, **kw)

    def counted_k2a(x, inv):
        calls["k2a"] += 1
        calls["k2a_on_int8"] += x.dtype == torch.int8
        return inner_k2a(x, inv)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (BasicBlock, Bottleneck))]
    try:
        with torch.inference_mode():
            model.cfg = dataclasses.replace(cfg, int8_resident=True)
            k2.int8_conv_cuda, k2.quantize_nhwc_cuda = counted, counted_k2a
            k2.int8_conv_requant_cuda = counted_requant
            resident_heat = model(crops, torch.float32)
    finally:
        k2.int8_conv_cuda, k2.quantize_nhwc_cuda = inner, inner_k2a
        k2.int8_conv_requant_cuda = inner_requant
        model.cfg = cfg
        for h in hooks:
            h.remove()
    if checked[0] != len(hooks) or not checked[0]:
        fail(f"int8-resident: {checked[0]} of {len(hooks)} blocks checked")
    # the stem is the one float-input conv without K2a; an int8 channels-
    # last input (the blocks' inter-conv tensors) launches none
    if calls["k2a_on_int8"] or calls["k2a"] != calls["float"] - 1 or not calls["int8"]:
        fail(f"int8-resident forward, channels-last: {calls}; expected K2a on every float "
             f"input but the stem's and on no int8 input")
    # the resident blocks' own convs (the generic checks above ran too)
    return {"card": card, "crops": SUB_CROPS, "blocks_checked": checked[0],
            "max_abs_diff": worst[0], "max_diff_over_bound": worst[1],
            "k2_calls_and_k2a": calls,
            "heatmap_max_abs_diff": float((resident_heat - generic_heat).abs().max())}


def phase_staged(torch, card, pipe, clip, frame_ids):
    """process_frame over the first 4 frames against process_clip on the
    same frames, one frame a clip, so that both run stage A on the same
    batch of views: cuDNN may sum a float conv (YOLOv3's head) in another
    order at another batch size, and on random weights an exp of such a
    sum can move a detection by millions."""
    n = 4
    pipe.track_restart()
    ref = [pipe.process_clip(frame_ids[t:t + 1], clip[t:t + 1]) for t in range(n)]
    pipe.track_restart()
    worst, replays = 0.0, card_replays()
    for t in range(n):
        out, dets, mask = pipe.process_frame(t, clip[t])
        outs_c, dets_c, mask_c = ref[t]
        if not torch.equal(mask, mask_c[0]):
            fail(f"process_frame {t}: masks differ from process_clip")
        if not torch.equal(out.valid, outs_c.valid[0]):
            fail(f"process_frame {t}: track validity differs from process_clip")
        err = (dets - dets_c[0]).abs()
        if bool((err > 2e-2 + 1e-3 * dets_c[0].abs()).any()):
            fail(f"process_frame {t}: detections differ from process_clip by up to "
                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    replays = card_replays() - replays
    if replays != n:
        fail(f"process_frame over {n} frames replayed the tracker's graph {replays} times")
    return {"card": card, "frames": n, "masks_equal": True, "dets_max_abs_diff": worst,
            "graph_replays": replays}


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
    / K2a / stem / epilogue launches counted from 0, then stage A
    (`process_clip_nn`, to a sync) unpacked and packed in turns; int8 also
    K2's launches at the packed input in each. The pipeline is left
    unpacked."""
    from tpupose_torch.ops import epilogue
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
    k2.requant_launches = k2.halo_launches = epilogue.launches = 0
    outs_p, dets_p, mask_p = pipe.process_clip(frame_ids, clip)
    torch.cuda.synchronize()
    launches = {"k1": th.launches, "k2": k2.launches, "k2a": k2.quantize_launches,
                "k2_stem": k2.stem_launches, "k2b_requant": k2.requant_launches,
                "k2b_halo": k2.halo_launches, "epilogue": epilogue.launches}
    expect = STEP_LAUNCHES[mode]
    if tuple(launches.values()) != (
            expect["heatmap.launches"], expect["int8_conv.launches"],
            expect["int8_conv.quantize_launches"], expect["int8_conv.stem_launches"],
            expect["int8_conv.requant_launches"], expect["int8_conv.halo_launches"],
            expect["epilogue.launches"]):
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
            out[f"k2_launches_at_packed_shape_{which}"] = k2_launches_at(
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
    return out


def phase_pack(torch, card, int8_pipe, float_models, clip, frame_ids):
    """Phase 16 (c): `Pipeline.pack_models` on phase 5's bf16 models and on
    phase 6's int8 pipeline, on phase 5's clip (see `pack_one`)."""
    from tpupose_torch.pipeline import Pipeline

    int8 = pack_one(torch, int8_pipe, clip, frame_ids, "int8")
    return {"card": card, "int8": int8,
            "bf16": pack_one(torch, Pipeline(*float_models), clip, frame_ids, "bf16")}


def oracle_summary(oracle):
    """{track id: (state, hits, time since update, last pose)} of the
    port's OracleTracker."""
    return {t.track_id: (t.state, t.hits, t.time_since_update, t.history[-1][1])
            for t in oracle.tracks}


def state_summary(torch, state, confirmed_state):
    """The same of a TrackerState, read on the host."""
    state = type(state)(*(x.cpu() for x in state))
    out = {}
    for i in torch.nonzero(state.active).flatten().tolist():
        count = int(state.hist_count[i])
        out[int(state.track_id[i])] = (confirmed_state if bool(state.confirmed[i]) else 1,
                                       int(state.hits[i]), int(state.time_since_update[i]),
                                       state.hist_pose[i, count - 1].numpy())
    return out


def phase_tracker(torch, card):
    import numpy as np

    import tpupose_torch.tracking.tracker as tt
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.ops import lap
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking import oracle as to

    frames, views, D = 24, 5, 4
    scene = make_scene(num_frames=frames, num_cameras=views, num_actors=3, seed=0)
    cams = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    cfg = tt.TrackerConfig(num_cameras=views, max_dets=D, max_tracks=12, max_hyp=24)
    gpu = Pipeline(cams, cfg, device="cuda")
    cpu = Pipeline(cams, cfg, device="cpu")
    oracle = to.OracleTracker(
        to.OracleTracker.make_cameras(*(np.asarray(getattr(cams, f))
                                        for f in ("P", "F", "rk_inv", "center"))),
        to.TrackerParams(max_tracks=cfg.max_tracks))

    step_s, syncs, err, oracle_err = 0.0, 0, 0.0, 0.0
    lap.launches = 0
    replays, before = card_replays(), set(card_steps())
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
        # the f64 oracle on the same detections, by tests/test_tracker_parity.py's rule
        oracle.step(t, [scene.detections[t, c][scene.visible[t, c]] for c in range(views)])
        ref, got = oracle_summary(oracle), state_summary(torch, gpu.state, to.CONFIRMED)
        if set(ref) != set(got):
            fail(f"tracker frame {t}: track ids {sorted(got)} on the card, {sorted(ref)} "
                 "in the oracle")
        for tid in ref:
            if ref[tid][:3] != got[tid][:3]:
                fail(f"tracker frame {t} track {tid}: (state, hits, time since update) "
                     f"{got[tid][:3]} on the card, {ref[tid][:3]} in the oracle")
            oracle_err = max(oracle_err, float(np.abs(ref[tid][3] - got[tid][3]).max()))
        valid_ids = set(out_g.track_id.cpu()[out_g.valid.cpu()].tolist())
        if valid_ids != {o["id"] for o in oracle.outputs(t)}:
            fail(f"tracker frame {t}: valid outputs {sorted(valid_ids)} against the oracle's")
    if not oracle_err < 5e-3:
        fail(f"the card tracker's poses lie {oracle_err} m from the oracle's (limit 5e-3)")
    confirmed = int(out_g.valid.sum())
    if confirmed != 3:
        fail(f"the tracker confirmed {confirmed} tracks on a 3-person scene")
    replays = card_replays() - replays
    k3 = lap.launches - graph_k3_warmups(before)
    if (replays, k3) != (frames, frames * (1 + views)):
        fail(f"person_track over {frames} frames: {replays} graph replays and {k3} K3 "
             f"launches, expected {frames} and {frames * (1 + views)}")
    return {"card": card, "frames": frames, "confirmed": confirmed,
            "ms_per_frame": step_s * 1e3 / frames, "graph_replays": replays,
            "k3_launches_per_frame": k3 / frames,
            "host_syncs_per_frame": syncs / frames, "pose3d_max_abs_diff_m": err,
            "oracle_pose3d_max_abs_diff_m": oracle_err}


CLI_FRAMES, CLI_CLIP, CLI_CALIB = 68, 32, 8  # 2 clips + 4 trailing frames
CLI_HEIGHT, CLI_WIDTH = 720, 1280
#: int8 convs whose activated output one other int8 conv alone reads, so
#: that K2b writes that conv's int8 input (`layers.chain_out`): HRNet-W48's
#: 104 basic blocks, 4 bottlenecks' 2 and 12 fuse-chain steps, YOLOv3-416's
#: 23 residual 1x1s and 3 x 4 conv-set steps (tests/test_torch_int8_requant.py).
REQUANT_PAIRS = (104 + 4 * 2 + 12) + (23 + 3 * 4)
#: int8 convs whose K2b launch takes the halo path (`ops.int8_conv.halo_path`,
#: by shape alone): HRNet-W48's 3x3 stride-1 convs of branches 0 (64) and 1
#: (64) and layer1 (4), packed branch 0 or not; none of YOLOv3-416's
#: (tests/test_torch_k2b_halo.py).
HALO_CONVS = 64 + 64 + 4
#: K1, K2, K2a, K2b-requantizing, K2b-halo and conv-epilogue launches per
#: `process_clip` or `process_frame` call (one stage A batch each): one
#: decode; in int8 the 364 quantized convs of YOLOv3-416 and HRNet-W48, 2 RGB
#: stems through the stem kernel, REQUANT_PAIRS of them writing the next
#: conv's int8 input, which then launches no K2a, so 362 - REQUANT_PAIRS
#: through K2a (phase 6's counts), HALO_CONVS of the 362 K2b launches on the
#: halo path; and one epilogue an engaged call site,
#: packed branch 0 or not: in bf16 HRNet's 292 convs of 8k outputs and 15
#: fuse rows' own branches, YOLOv3's 72 convs with BN; in int8 16 fewer, the
#: call sites whose only term is a float conv's bias (HRNet's downsample and
#: the fuse rows' first terms), which K2 adds, and REQUANT_PAIRS fewer, the
#: activations K2b applies.
STEP_LAUNCHES = {
    "bf16": {"heatmap.launches": 1, "int8_conv.launches": 0,
             "int8_conv.quantize_launches": 0, "int8_conv.stem_launches": 0,
             "int8_conv.requant_launches": 0, "int8_conv.halo_launches": 0,
             "epilogue.launches": 307 + 72},
    "int8": {"heatmap.launches": 1, "int8_conv.launches": 364,
             "int8_conv.quantize_launches": 362 - REQUANT_PAIRS,
             "int8_conv.stem_launches": 2, "int8_conv.requant_launches": REQUANT_PAIRS,
             "int8_conv.halo_launches": HALO_CONVS,
             "epilogue.launches": 291 + 72 - REQUANT_PAIRS},
}


#: Launches of one ViTPose-H stage-A batch (a 32-frame clip of 5 views, 640
#: crops): the epilogue's at YOLOv3-416's 72 call sites and the head's two
#: transposed convs, the fused attention's one a block, K1's one (phase 22).
VITPOSE_LAUNCHES = {"epilogue.launches": 72 + 2, "attention.launches": 32,
                    "heatmap.launches": 1}


#: Launches of one HRFormer-B stage-A batch (a 32-frame clip of 5 views,
#: 640 crops): the epilogue's at YOLOv3-416's 72 call sites and HRFormer's
#: 233 (the stem's 2, stage 1's 7, the transitions' 4, three a block's FFN
#: over 44 blocks, the fuse layers' 88), the fused attention's one a block,
#: K1's one (phase 23).
HRFORMER_LAUNCHES = {"epilogue.launches": 72 + 233, "attention.launches": 44,
                     "heatmap.launches": 1}


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


def cli_loop(torch, cfg, pipe, frames, card, counters, source=None, timer=None):
    """`cli.common.run_eval_loop` over the in-memory frames, or the frames
    of `source` (a `dataset_frame_source` writing to `timer`, CLI_FRAMES of
    them), in CLI_CLIP-frame clips, with every counter of `counters` (module,
    attribute) set to 0 just before and read just after; each clip and each
    trailing frame timed to a device sync."""
    from tpupose_torch.cli import common as cli
    from tpupose_torch.ops import lap
    from tpupose_torch.utils.timing import StageTimer

    calls = {"process_clip": [], "process_frame": []}
    returned = {"process_clip": [], "process_frame": []}  # host clock at return
    started = []  # host clock at each call's start
    syncs = [0]
    detections = []  # (detections, mask) of each call, in order

    def timed(name):
        fn = getattr(pipe, name)

        def run(*args, **kw):
            t0 = time.perf_counter()
            started.append(t0)
            with counted_syncs() as counted:
                out = fn(*args, **kw)
            returned[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            calls[name].append((time.perf_counter() - t0) * 1e3)
            syncs[0] += counted["syncs"]
            detections.append(out[1:])
            return out
        return run

    def in_memory():
        for t in range(frames.shape[0]):
            yield t, t, frames[t], None, None

    n = frames.shape[0] if source is None else CLI_FRAMES

    pipe.track_restart()
    pipe.process_clip, pipe.process_frame = timed("process_clip"), timed("process_frame")
    timer = StageTimer() if timer is None else timer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for module, attr in counters:
        setattr(module, attr, 0)
    lap.launches = 0
    replays, before = card_replays(), set(card_steps())
    t0 = time.perf_counter()
    try:
        with nchw_conv_inputs(torch, pipe.detector, pipe.pose_model) as layouts:
            multi_poses3d, annotations = cli.run_eval_loop(
                cfg, pipe, in_memory() if source is None else source, timer, clip=CLI_CLIP)
            torch.cuda.synchronize()
    finally:
        del pipe.process_clip, pipe.process_frame
    loop_s = time.perf_counter() - t0
    check_channels_last(layouts, "the CLI loop")
    launches = {f"{module.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(module, attr)
                for module, attr in counters}
    n_clips, n_tail = divmod(n, CLI_CLIP)
    if (len(calls["process_clip"]), len(calls["process_frame"])) != (n_clips, n_tail):
        fail(f"the CLI loop made {len(calls['process_clip'])} process_clip and "
             f"{len(calls['process_frame'])} process_frame calls, expected {n_clips} "
             f"and {n_tail}")
    if sorted(multi_poses3d) != list(range(n)):
        fail("the CLI loop did not harvest every frame")
    views = len(cfg.dataset.folders_order)
    replays = card_replays() - replays
    k3_launches = lap.launches - graph_k3_warmups(before)  # a capture's warm-up ran too
    if (k3_launches, replays) != (n * (1 + views), n):
        fail(f"the CLI loop launched K3 {k3_launches} times in {replays} graph replays, "
             f"expected {n * (1 + views)} in {n}")
    return {
        "card": card, "loop_s": loop_s, "clip_ms": calls["process_clip"],
        "ms_per_clip": statistics.median(calls["process_clip"]),
        "clip_returned_ms": returned["process_clip"],
        "frame_ms": calls["process_frame"],
        "ms_per_trailing_frame": statistics.median(calls["process_frame"]),
        "timer_report": timer.report(num_views=len(cfg.dataset.folders_order)).splitlines(),
        "launches": launches, "k3_launches": k3_launches, "graph_replays": replays,
        "conv_inputs": layouts, "captured_here": len(set(card_steps()) - before),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "host_syncs_per_frame": syncs[0] / n,
        "confirmed_track_frames": sum(len(p) for p in multi_poses3d.values()),
        "annotations": len(annotations), "first_call_at": started[0],
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
    files, in bf16 and then int8; then phase 16 (a), (b) and phase 17 on
    those files. Returns the three phases' results."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    import numpy as np

    from tpupose_torch.cli import common as cli
    from tpupose_torch.data.config import config_from_raw
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.ops import epilogue
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2

    counters = [(th, "launches"), (k2, "launches"), (k2, "quantize_launches"),
                (k2, "stem_launches"), (k2, "requant_launches"), (k2, "halo_launches"),
                (epilogue, "launches")]
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
        ingest = phase_ingest(torch, card, root, weights, checkpoint, out["bf16"])
    return out, bundles, ingest


#: Phase 17 (ingest): phase 10's frame count, 5 views of 720x1280 at
#: quality 90 (Pillow's default 4:2:0 chroma), the CLI's decode-ahead depth
#: for --clip 32, and the Pillow pool's thread counts.
INGEST_QUALITY, INGEST_PREFETCH, INGEST_THREADS = 90, 32, (1, 2, 4, 8)
#: nvJPEG against Pillow on the same files, per channel, in levels (mean
#: and 99.9th percentile of |difference|): the JPEG standard fixes neither
#: the IDCT nor the chroma upsampling, so the decoders need not agree bit
#: for bit. DECODE_LIMIT is the loosest gate allowed: a worse reading is a
#: fault of the loader. DECODE_GATE is set from the reading on the H100
#: (PERF.md): with nvJPEG's interpolated chroma upsampling, mean
#: 0.57-0.76 and 99.9th percentile 2-3 on the photo-like files, 0.01-0.02
#: and 1-2 on the stick figures, the same on every backend; with its
#: default replication, 2.06-3.99 and 23-47 (the fault the flag repairs).
DECODE_LIMIT = {"mean": 2.0, "p999": 16}
DECODE_GATE = {"mean": 1.0, "p999": 4}


def decode_histogram(torch, got, ref, hist):
    """Adds the per-channel histogram of |got - ref| over two (..., 3)
    uint8 frames on the card to `hist` (3, 256) int64."""
    d = (got.to(torch.int16) - ref.to(torch.int16)).abs().long()
    d = d + torch.arange(3, device=d.device) * 256
    hist += torch.bincount(d.flatten(), minlength=768).view(3, 256)


def decode_stats(torch, hist):
    """Mean, 99.9th percentile and max |difference| per channel."""
    levels = torch.arange(256, device=hist.device, dtype=torch.float64)
    n = hist.sum(dim=1)
    cdf = hist.cumsum(dim=1)
    out = {"mean": (hist.double() * levels).sum(dim=1) / n.double(),
           "p999": (cdf < 0.999 * n[:, None]).sum(dim=1),
           "max": torch.tensor([int(torch.nonzero(h).max()) for h in hist])}
    return {k: [float(x) for x in v.cpu()] for k, v in out.items()}


def check_decode(what, stats, gate):
    for key in ("mean", "p999"):
        worst = max(stats[key])
        if worst > gate[key]:
            fail(f"{what}: nvJPEG lies {worst} levels ({key}) from Pillow, over the "
                 f"gate of {gate[key]}")


def decoded(torch, loader_mod, frame_paths, **kw):
    """Every frame of a `FrameLoader(frame_paths, **kw)`, in order."""
    with loader_mod.FrameLoader(frame_paths, **kw) as frames:
        out = list(frames)
    torch.cuda.synchronize()
    return out


def against_pillow(torch, loader_mod, frame_paths, pillow, backend):
    """nvJPEG (`backend`) against the Pillow frames `pillow` of the same
    files: the per-channel statistics of |difference|."""
    hist = torch.zeros((3, 256), dtype=torch.int64, device="cuda")
    with loader_mod.FrameLoader(frame_paths, prefetch=8, threads=2, device="cuda",
                                backend=backend) as frames:
        for got, ref in zip(frames, pillow, strict=True):
            decode_histogram(torch, got, torch.from_numpy(ref).cuda(), hist)
    return decode_stats(torch, hist)


def recording_timer():
    """A StageTimer that also keeps every decode_wait it is given, with
    the host clock when it was given, in `waits`."""
    from tpupose_torch.utils.timing import StageTimer

    class Recording(StageTimer):
        def __init__(self):
            super().__init__()
            self.waits = []

        def add(self, stage, seconds, count=1):
            if stage == "decode_wait":
                self.waits.append((time.perf_counter(), seconds))
            super().add(stage, seconds, count)

    return Recording()


def phase_ingest(torch, card, root, weights, checkpoint, cli10):
    """Phase 17: the frame loader from disk. (a) nvJPEG against Pillow on
    photo-like and stick-figure JPEGs, and nvJPEG's frame order; (b) decode
    rates; (c) disk to the card; (d) the evaluation CLI's loop from disk
    against the same frames held in memory (and phase 10's loop, `cli10`)."""
    import numpy as np

    from tpupose_torch.cli import common as cli
    from tpupose_torch.data.config import config_from_raw
    from tpupose_torch.data.fabricate import fabricate_mini_dataset
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.runtime import ingest_bench as ib
    from tpupose_torch.runtime import loader as tl

    out = {"card": card, "host_cpus": os.cpu_count(), "default_backend": tl.DEFAULT_BACKEND}
    data = os.path.join(root, "ingest")
    t0 = time.perf_counter()
    paths = ib.fabricate_jpeg_dataset(data, num_frames=CLI_FRAMES, num_views=5,
                                      width=CLI_WIDTH, height=CLI_HEIGHT,
                                      quality=INGEST_QUALITY)
    out["fabricate_s"] = time.perf_counter() - t0
    out["jpeg_kb"] = os.path.getsize(paths[0][0]) / 1024
    _, stick = fabricate_mini_dataset(os.path.join(root, "stick"), num_frames=24)
    stick_paths = [[os.path.join(stick["root"], f"Camera{c}", f"campus4-c{c}-{t}.jpg")
                    for c in range(3)] for t in range(24)]

    # (a) nvJPEG against Pillow, every backend the card accepts; frame order
    backends, refused = tl.accepted_backends("cuda")
    if tl.DEFAULT_BACKEND not in backends:
        fail(f"the card refuses nvJPEG's {tl.DEFAULT_BACKEND} backend: "
             f"{refused[tl.DEFAULT_BACKEND]}")
    reading = {"refused": refused, "gate": DECODE_GATE, "limit": DECODE_LIMIT}
    for name, frame_paths in (("photo", paths), ("stick", stick_paths)):
        pillow = decoded(torch, tl, frame_paths, prefetch=8, threads=8)
        reading[name] = {b: against_pillow(torch, tl, frame_paths, pillow, b) for b in backends}
        del pillow
    emit("ingest_decode", **reading)  # before the gates, so that a failing reading shows
    for name in ("photo", "stick"):
        for b, stats in reading[name].items():
            check_decode(f"{name} JPEGs, {b} backend", stats, DECODE_GATE)
    in_order = decoded(torch, tl, paths, prefetch=1, threads=1, device="cuda")
    frames = decoded(torch, tl, paths, prefetch=8, threads=4, device="cuda")
    if len(frames) != CLI_FRAMES or not all(torch.equal(a, b) for a, b in zip(frames, in_order)):
        fail("nvJPEG with 4 threads ahead gives other frames, or another order, than one "
             "frame at a time")
    del in_order
    reading["order"] = f"{CLI_FRAMES} frames torch.equal to one-at-a-time decoding"
    out["a"] = reading

    # (b) decode rates; (c) disk -> card
    out["b"] = ib.bench_decode(paths, threads_list=INGEST_THREADS, prefetch=8, device="cuda",
                               backends=backends)
    out["b"]["nvjpeg_4_threads"] = ib.bench_decode(
        paths, threads_list=(), prefetch=8, use_pil_baseline=False, device="cuda",
        backends=(tl.DEFAULT_BACKEND,), card_threads=4)["nvjpeg"]
    best = max(out["b"]["pillow"], key=out["b"]["pillow"].get)
    out["c"] = {
        "pillow": {"threads": best, **ib.bench_disk_to_device(paths, threads=best, prefetch=8,
                                                              device="cuda", route="pillow")},
        "nvjpeg": {"threads": 2, "backend": tl.DEFAULT_BACKEND, **ib.bench_disk_to_device(
            paths, threads=2, prefetch=8, device="cuda", route="nvjpeg")}}

    # (d) the CLI's loop over (a)'s frames in memory, then from disk
    raw = shelf_config(data, weights, checkpoint)
    raw["DATASET"]["TEST_RANGE"] = [0, CLI_FRAMES]
    cfg = config_from_raw(raw)
    scene = make_scene(num_frames=CLI_FRAMES, num_cameras=5, num_actors=3, seed=0)
    pipe = cli.build_pipeline_real(cfg, {"P": scene.P, "K": scene.K, "RT": scene.RT},
                                   CLI_WIDTH, CLI_HEIGHT)
    counters = [(th, "launches")]
    # one clip first, so that neither loop pays the first call (the loops
    # restart the tracker); then the same frames in memory, then from disk
    pipe.process_clip(list(range(CLI_CLIP)), torch.stack(frames[:CLI_CLIP]))
    torch.cuda.synchronize()
    memory, (poses_m, _, dets_m) = cli_loop(torch, cfg, pipe, torch.stack(frames), card,
                                            counters)
    del frames
    timer = recording_timer()
    tl.nvjpeg_images = 0
    source = cli.dataset_frame_source(cfg, True, timer, prefetch=INGEST_PREFETCH, device="cuda")
    disk, (poses, _, dets) = cli_loop(torch, cfg, pipe, None, card, counters, source=source,
                                      timer=timer)
    images = tl.nvjpeg_images
    if images != CLI_FRAMES * 5:
        fail(f"the CLI loop from disk decoded {images} images with nvJPEG, expected "
             f"{CLI_FRAMES * 5}")
    calls = sum(divmod(CLI_FRAMES, CLI_CLIP))  # one K1 launch a clip or trailing frame
    if disk["launches"] != {"heatmap.launches": calls}:
        fail(f"the CLI loop from disk launched K1 {disk['launches']}, expected {calls}")
    if len(dets) != len(dets_m) or not all(torch.equal(a, b) for got, want in zip(dets, dets_m)
                                           for a, b in zip(got, want)):
        fail("the CLI loop from disk: stage A detections differ from the same frames in memory")
    if list(poses) != list(poses_m) or not all(
            np.array_equal(poses[t], poses_m[t]) for t in poses_m):
        fail("the CLI loop from disk: poses differ from the same frames in memory")
    # the frames pulled before the first clip starts against those after:
    # the loader decodes the latter while the card runs stage A and B
    before = [w for at, w in timer.waits if at <= disk["first_call_at"]]
    after = [w for at, w in timer.waits if at > disk["first_call_at"]]
    keep = ("loop_s", "ms_per_clip", "clip_ms", "ms_per_trailing_frame", "launches",
            "k3_launches", "peak_mem_gib", "host_syncs_per_frame")
    out["d"] = {
        "nvjpeg_images": images, "detections_equal": True, "poses_equal": True,
        "detections_valid": sum(int(m.sum()) for _, m in dets),
        "disk": {**{k: disk[k] for k in keep}, "timer_report": disk["timer_report"]},
        "memory": {k: memory[k] for k in keep},
        "decode_wait_before_first_clip": {"frames": len(before), "s": sum(before)},
        "decode_wait_after_first_clip": {
            "frames": len(after), "ms_per_frame": 1e3 * sum(after) / max(len(after), 1),
            "ms_max": 1e3 * max(after, default=0.0)},
        "decode_work_ms_per_frame": 1e3 * timer.per_frame("decode_work"),
        "phase10_bf16": None if cli10 is None else {k: cli10[k] for k in (
            "loop_s", "ms_per_clip", "ms_per_trailing_frame")},
    }
    return out


def standalone_ingest(torch, card):
    """Phase 17 alone (`--only ingest`): phase 10's checkpoints written anew
    from its seed, no phase 10 loop to compare with."""
    import tempfile

    from tpupose_torch.cli import common as cli
    from tpupose_torch.data.config import config_from_raw

    with tempfile.TemporaryDirectory() as root:
        probe = config_from_raw(shelf_config(root, "", ""))
        weights, checkpoint, _, _ = write_checkpoints(torch, root, cli.yolo_config_from(probe),
                                                      cli.hrnet_config_from(probe))
        return phase_ingest(torch, card, root, weights, checkpoint, None)


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
        """Per model: the logged steps and losses, and ms per step from the
        first logged step after the capture (WARMUP + 1) to the last, so
        the replays' rate (an eager run's steps alike)."""
        from tpupose_torch.runtime.graphs import WARMUP

        out = []
        for model, run in zip(("yolov3_416", "hrnet_w48"), self.runs):
            (s0, l0, t0), (s1, l1, t1) = run[0], run[-1]
            sa, _, ta = next((r for r in run if r[0] > WARMUP + 1), run[0])
            out.append({"model": model, "steps_logged": [s for s, _, _ in run],
                        "losses": [v for _, v, _ in run], "first_loss": l0, "last_loss": l1,
                        "ms_per_step": (t1 - ta) * 1e3 / (s1 - sa) if s1 > sa else None,
                        "timed_from_step": sa, "steps_before_s": ta - t0})
        return out


def startup_900_s(models):
    """A 900-step escalation's distill-QAT seconds, both models: 900 steps
    at the timed rate, plus what the steps up to the timed ones cost beyond
    it (the warm-ups and the capture)."""
    return sum(900 * m["ms_per_step"] / 1e3 + m["steps_before_s"]
               - (m["timed_from_step"] - m["steps_logged"][0]) * m["ms_per_step"] / 1e3
               for m in models)


def qat_run(torch, models, calib, eager):
    """`quantize_models(qat_steps=QAT_STEPS)` on a fresh pipeline of the
    float `models`, no self-check, captured or (`eager`) inside
    `disable_capture()`: (the pipeline, QatLog's summary)."""
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.runtime.graphs import disable_capture

    pipe, log = Pipeline(*models), QatLog(torch)
    with disable_capture() if eager else contextlib.nullcontext():
        pipe.quantize_models(calib, qat_steps=QAT_STEPS, on_drift="warn", check_px=None,
                             qat_log=log)
    return pipe, log.summary()


def qat_graphed_against_eager(torch, models, calib):
    """Phase 11's gate: `qat_run` captured and eager, both under cuDNN
    deterministic: the same logged losses and the int8 modules equal
    tensor for tensor. Then eager again without deterministic, the rate
    the captured `qat` leg compares with. Each run's ms per step, and
    the 900 + 900-step start-up at each rate."""
    torch.backends.cudnn.deterministic = True
    try:
        pg, lg = qat_run(torch, models, calib, eager=False)
        pe, le = qat_run(torch, models, calib, eager=True)
    finally:
        torch.backends.cudnn.deterministic = False
    differ = [f"{which}.{k}" for which in ("detector", "pose_model")
              for (k, a), b in zip(getattr(pg, which).state_dict().items(),
                                   getattr(pe, which).state_dict().values())
              if not torch.equal(a, b)]
    tensors = len(pg.detector.state_dict()) + len(pg.pose_model.state_dict())
    if differ or [m["losses"] for m in lg] != [m["losses"] for m in le]:
        fail(f"distill-QAT captured against eager (cuDNN deterministic): {differ[:8]} of "
             f"{tensors} tensors differ; losses {[m['losses'] for m in lg]} against "
             f"{[m['losses'] for m in le]}")
    del pg, pe
    _, eager = qat_run(torch, models, calib, eager=True)
    return {"steps": QAT_STEPS, "cudnn_deterministic": True, "tensors_equal": tensors,
            "graphed": lg, "eager": le, "startup_900_s": {
                "graphed": startup_900_s(lg), "eager": startup_900_s(le)},
            "eager_not_deterministic": {"models": eager, "startup_900_s": startup_900_s(eager)}}


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
                  "startup_900_s": startup_900_s(qat_log.summary())}
    out["graphed_against_eager"] = qat_graphed_against_eager(torch, models, calib)

    pipe.track_restart()
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()
    th.launches = k2.launches = k2.quantize_launches = k2.requant_launches = 0
    k2.halo_launches = 0
    t0 = time.perf_counter()
    outs, dets, mask = pipe.process_clip(frame_ids, clip)
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t0) * 1e3
    launches = {"k1": th.launches, "k2": k2.launches, "k2a": k2.quantize_launches,
                "k2b_requant": k2.requant_launches, "k2b_halo": k2.halo_launches}
    expect = STEP_LAUNCHES["int8"]
    expect = {"k1": 1, "k2": expect["int8_conv.launches"],
              "k2a": expect["int8_conv.quantize_launches"],
              "k2b_requant": expect["int8_conv.requant_launches"],
              "k2b_halo": expect["int8_conv.halo_launches"]}
    if launches != expect:
        fail(f"the int8 clip after distill-QAT launched {launches}, expected {expect}")
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
            replays, before = card_replays(), set(card_steps())
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
                            (counted.get("syncs"), lap.launches - graph_k3_warmups(before),
                             card_replays() - replays))
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
    if counts[2] != CLI_TRACK_FRAMES:
        fail(f"CLI tracks: {counts[2]} graph replays on the card over {CLI_TRACK_FRAMES} frames")
    return {"card": card, "frames": CLI_TRACK_FRAMES,
            "capacities": [tcfg.max_dets, tcfg.max_tracks, tcfg.max_hyp],
            "track_ids": len({pid for _, _, pid in ids_card}),
            "confirmed_track_frames": confirmed, "annotations": len(ids_card),
            "camera_jsons": len(js_card), "json_bytes": sum(map(len, js_card.values())),
            "pose3d_max_abs_diff_m": worst, "card_ms_per_frame": s_card * 1e3 / CLI_TRACK_FRAMES,
            "cpu_ms_per_frame": s_cpu * 1e3 / CLI_TRACK_FRAMES,
            "card_host_syncs_per_frame": counts[0] / CLI_TRACK_FRAMES,
            "card_k3_launches_per_frame": counts[1] / CLI_TRACK_FRAMES,
            "card_graph_replays": counts[2]}


TRAIN_BATCH, TRAIN_STEPS, RESUME_AT = 8, 20, 10  # phase 13 (a), (b), (d)
TRAIN_TIMED_FROM = 5     # ms per step: median of steps 5..20 (1-based)
TF32_STEPS = 8           # (b) again with TF32 on, a second key: 2 warm-ups, a capture
RESUME_STEPS = 4         # (d): steps from the restored objects, the 3rd captures
EAGER_STEPS = 8          # (a), (b): eager steps timed, the median of the last 6
HOST_REPLAYS = 5         # (a), (b): replays timed on the host behind one sleep
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


def capture_report(torch, step, batch):
    """A captured training step's figures: each key's (its graph's nodes by
    type, capture seconds, pool MiB, replays), then, on `batch`, the host's
    µs for one replay while the card sleeps and the card's ms for one
    replay alone (two more real steps each)."""
    keys = []
    for k in step.stats():
        keys.append({"batch": k["shapes"][0], "dtypes": k["dtypes"], "flags": k["flags"],
                     "warmups": k["warmups"], "replays": k["replays"],
                     "capture_s": k["capture_s"], "pool_mib": k["pool_bytes"] / 2**20,
                     "graph_nodes": k["graph_nodes"]})
    return {"keys": keys,
            "host_us_per_replay": host_us_behind_sleep(torch, lambda: step(*batch),
                                                       n=HOST_REPLAYS),
            "device_ms_per_replay": device_ms_behind_sleep(torch, lambda: step(*batch))}


def everything(tt, model, opt):
    """{name: tensor} of every trained tensor, its `.grad` and its optimizer
    state."""
    out = {}
    for name, t in tt.named_trained_tensors(model):
        out[name] = t.detach()
        out[name + ".grad"] = t.grad
        for k, v in opt.state[t].items():
            out[f"{name}.{k}"] = v
    return out


def graphed_against_eager(torch, tt, build, batches, what):
    """(a), (b): the recipe's captured step and its eager body from the same
    weights on the same TRAIN_STEPS batches, both under cuDNN deterministic:
    every loss, trained tensor, `.grad` and optimizer state tensor
    torch.equal. Then the eager step alone, without deterministic, for
    EAGER_STEPS more steps: its ms per step, host to a sync, and peak
    memory."""
    from tpupose_torch.runtime.graphs import WARMUP, disable_capture

    (mg, og, sg), (me, oe, se) = build(), build()
    torch.backends.cudnn.deterministic = True
    try:
        graphed = [sg(*b) for b in batches]
        with disable_capture():
            eager = [se(*b) for b in batches]
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    bad = [i for i, (a, b) in enumerate(zip(graphed, eager)) if not torch.equal(a, b)]
    tensors = everything(tt, mg, og)
    ref = everything(tt, me, oe)
    bad += [k for k, v in ref.items()
            if v is None or tensors.get(k) is None or not torch.equal(tensors[k], v)]
    replays = [k["replays"] for k in sg.stats()]
    if bad or tensors.keys() != ref.keys() or replays != [len(batches) - WARMUP]:
        fail(f"{what}: the captured step differs from the eager body under cuDNN deterministic "
             f"at {bad[:8]} ({len(bad)} in all; replays {replays})")
    del mg, og, sg, tensors, ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with disable_capture():
        _, ms = train_steps(torch, se, iter(batches), EAGER_STEPS)
    return {"steps": len(batches), "cudnn_deterministic": True, "losses_equal": len(batches),
            "tensors_equal": len(everything(tt, me, oe)), "graphed_replays": replays[0],
            "eager_step_ms": ms, "eager_ms_per_step": statistics.median(ms[2:]),
            "eager_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


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
    fresh objects, hold every tensor torch.equal, then take RESUME_STEPS
    more steps from each on `batch` (cuDNN deterministic, a new key for
    both: 2 warm-ups, then the fresh step captures its graph over the
    restored tensors) and compare the losses and the gradients."""
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
    if not fresh_opt.param_groups[0]["capturable"]:
        fail("resume: the restored optimizer is not capturable")
    fresh_step = tt.make_train_step(fresh, fresh_opt, torch.bfloat16)
    torch.backends.cudnn.deterministic = True
    try:
        losses = [(step(*batch), fresh_step(*batch)) for _ in range(RESUME_STEPS)]
    finally:
        torch.backends.cudnn.deterministic = False
    worst, where = worst_rel(torch, trained_grads(tt, fresh), trained_grads(tt, model))
    if not worst <= TRAIN_GRAD_LIMITS[False]:
        fail(f"resume: the next step's gradient of {where} differs by {worst}")
    (fresh_key,) = fresh_step.stats()
    if fresh_key["replays"] != RESUME_STEPS - fresh_key["warmups"] or fresh_key["replays"] < 1:
        fail(f"resume: the restored step did not capture and replay ({fresh_key})")
    sizes = {"model_mb": os.path.getsize(paths[0]) / 1e6,
             "optimizer_mb": os.path.getsize(paths[1]) / 1e6}
    del fresh, fresh_opt, fresh_step
    return {"tensors_equal": tensors, **sizes, "save_s": save_s, "restore_s": restore_s,
            "next_step_losses": [[float(a), float(b)] for a, b in losses],
            "next_step_losses_equal": all(bool(torch.equal(a, b)) for a, b in losses),
            "next_step_grad_worst_rel": worst, "next_step_grad_worst_at": where,
            "restored_step": {k: fresh_key[k] for k in ("warmups", "replays", "capture_s")},
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
    `int8_conv_plain` on the same input, as phase 4 holds K2, and each that
    writes the next conv's int8 input (`layers.int8_conv_requant`) to
    `int8_conv_requant_plain` (the plain calls launch nothing). Yields a
    report: the convs held, how many took the gather route and how many
    requantized, and the number of distinct (input shape, Cout, k, stride,
    dtype) of the others."""
    from tpupose_torch.models import layers
    from tpupose_torch.ops import int8_conv as k2

    inner, inner_requant = layers.int8_conv, layers.int8_conv_requant
    report = {"convs": 0, "stem_convs": 0, "gather_convs": 0, "requantizing_convs": 0,
              "distinct_shapes": set()}

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

    def held_requant(x, weight_q, weight_k, inv, mul, add, mid, act, inv_next, stride=1,
                     dilation=1):
        y = inner_requant(x, weight_q, weight_k, inv, mul, add, mid, act, inv_next, stride,
                          dilation)
        ref = k2.int8_conv_requant_plain(x, weight_q, inv, mul, add, mid, act, inv_next,
                                         stride, dilation)
        if not torch.equal(y, ref):
            fail(f"{what}: K2b requantizing at {tuple(x.shape)} -> {tuple(y.shape)} differs "
                 f"from the plain version in {int((y != ref).sum())} codes")
        report["convs"] += 1
        report["requantizing_convs"] += 1
        return y

    layers.int8_conv, layers.int8_conv_requant = held, held_requant
    try:
        yield report
    finally:
        layers.int8_conv, layers.int8_conv_requant = inner, inner_requant
        report["distinct_shapes"] = len(report["distinct_shapes"])


def learned_tiny(torch, tt, seed=LEARN_SEED, gate=True):
    """Phase 13 (e): the tiny HRNet (weights from `seed`) trained on the card
    to localize blobs (capturable Adam 1e-3, f32, LEARN_STEPS steps, all but
    the first WARMUP replays of one CUDA graph, on one batch of
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
    opt = torch.optim.Adam(tt.trained_tensors(model), lr=1e-3, capturable=True)
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
    (key,) = step.stats()
    del step
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
            "optimizer": "Adam 1e-3, capturable", "replays": key["replays"],
            "capture_s": key["capture_s"], "graph_nodes": key["graph_nodes"],
            "last_loss": last, "untrained_px": untrained, "float_px": float_px,
            "int8_px": int8_px, "int8_launches": launches, "k2_held_to_plain": held,
            "limits": {"float_px": LEARNED_PX, "gain": LEARN_GAIN, "int8_px": INT8_PX}}, \
        (cfg, folded, qmodel)


def w48_recipe(torch, tt, cfg, name):
    """(model, optimizer, captured step) of phase 13's recipe (a), AdamW in
    bf16 with inference-mode BN, or (b), Adam 1e-3 in f32 with train-mode
    BN, from the recipe's seed."""
    from tpupose_torch.models.hrnet import hrnet_init

    model = hrnet_init(cfg, torch.Generator().manual_seed(20 if name == "a" else 23)).cuda()
    if name == "a":
        opt = tt.make_optimizer(tt.trained_tensors(model))
        return model, opt, tt.make_train_step(model, opt, torch.bfloat16)
    opt = torch.optim.Adam(tt.trained_tensors(model), lr=1e-3, capturable=True)
    return model, opt, tt.make_train_step(model, opt, torch.float32, train_bn=True)


def phase_train_profile(torch, card):
    """Phase 13 (f), after phase 19 (a profile leaves CUPTI attached, and
    every later graph launch costs the host more): for W48 recipes (a) and
    (b), one eager step and one replay of the captured step under
    torch.profiler, after the warm-ups and the capture: the kernels each
    launches against the graph's kernel nodes, and the device's busy ms."""
    import numpy as np

    from tpupose_torch.models import train as tt
    from tpupose_torch.models.hrnet import hrnet_w48_config
    from tpupose_torch.runtime.graphs import WARMUP

    cfg = hrnet_w48_config()
    out = {"card": card}
    for name in ("a", "b"):
        model, opt, step = w48_recipe(torch, tt, cfg, name)
        batch = next(blob_batches(tt, np.random.default_rng(2), cfg, TRAIN_BATCH))
        for _ in range(WARMUP + 2):
            step(*batch)
        torch.cuda.synchronize()
        runs = {"eager": profiled_device_events(torch, lambda: step.eager(*batch)),
                "replay": profiled_device_events(torch, lambda: step(*batch))}
        (key,) = step.stats()
        for run in runs.values():
            if isinstance(run, dict):
                run["kernels"] = run["device_events"] - run["memcpy_memset"]
                run["busy_ms"] = run["busy_us"] / 1e3
        out[name] = {**runs, "graph_nodes": key["graph_nodes"]}
        del model, opt, step
        torch.cuda.empty_cache()
    return out


def device_events(torch, prof):
    """The kernels and copies of a torch.profiler session: its device-side
    events less the program's `span:*` ranges, which the profiler mirrors
    onto the device's timeline."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("span:")]


#: Calls in one timed sample of phase 21, so that the host's wrapper time
#: hides behind the card's queue, as on the main path.
EPILOGUE_CALLS = 10


def queued_ms(fn, calls=EPILOGUE_CALLS):
    """Median ms of one fn() by CUDA events around `calls` calls in a row."""
    return cuda_time_ms(lambda: [fn() for _ in range(calls)], reps=10) / calls


#: (name, output shape, up, act, act_first) of phase 21, each with a bias
#: and a skip: HRNet-W48's branch 0 at 640 crops (a basic block's last
#: conv), its stage-4 fuse row 0 reading branch 3 upsampled 8x, and
#: YOLOv3-416's shortcut at 52x52 on 160 images.
EPILOGUE_SHAPES = (
    ("hrnet_branch0_skip_relu", (640, 48, 96, 72), 0, "relu", False),
    ("hrnet_fuse_up8_skip_relu", (640, 48, 96, 72), 3, "relu", False),
    ("yolo_shortcut_52_leaky", (160, 256, 52, 52), 0, "leaky", True),
)


def cudnn_fused_conv(torch, gen, epilogue):
    """cuDNN's fused conv-bias-add-ReLU at branch 0's 3x3 48->48 conv on
    640 crops, bf16 channels-last: its first call's seconds (the fusion
    engine's set-up) and steady ms, against `F.conv2d` alone, `F.conv2d`
    plus the epilogue kernel, and the composed passes; or the error as a
    string. Context for moving the epilogue into the conv: the port never
    calls the fused op."""
    import torch.nn.functional as F

    b16, cl = torch.bfloat16, torch.channels_last
    mk = dict(generator=gen, device="cuda")
    x = torch.randn((640, 48, 96, 72), **mk).to(b16).contiguous(memory_format=cl)
    z = torch.randn((640, 48, 96, 72), **mk).to(b16).contiguous(memory_format=cl)
    wgt = (torch.randn((48, 48, 3, 3), **mk) * 0.07).to(b16).contiguous(memory_format=cl)
    bias = torch.randn(48, **mk).to(b16)

    def fused():
        return torch.cudnn_convolution_add_relu(x, wgt, z, 1.0, bias, (1, 1), (1, 1),
                                                (1, 1), 1)

    def ours():
        return epilogue.bias_act_cuda(F.conv2d(x, wgt, None, padding=1), bias, z, 0, "relu")

    out = {"shape": [640, 48, 96, 72, 48, 3, 1]}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fused()
        torch.cuda.synchronize()
        out["first_call_s"] = time.perf_counter() - t0
        out["ms"] = queued_ms(fused)
        out["max_abs_diff_vs_ours"] = float((y.float() - ours().float()).abs().max())
    except Exception as e:  # a cuDNN without the fusion engine: report, do not gate
        out["fused"] = f"not measured: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    out["conv_ms"] = queued_ms(lambda: F.conv2d(x, wgt, None, padding=1))
    out["conv_plus_epilogue_ms"] = queued_ms(ours)
    out["composed_ms"] = queued_ms(lambda: F.relu(F.conv2d(x, wgt, bias, padding=1) + z))
    return out


def phase_epilogue(torch, card):
    """Phase 21: the one-pass conv epilogue at EPILOGUE_SHAPES in bf16, the
    kernel against its plain version (the composed PyTorch passes) bit for
    bit and by its largest absolute difference, each one's ms by CUDA events
    (`queued_ms`), the kernel's byte bound (src, skip and output once each),
    then `cudnn_fused_conv`."""
    from tpupose_torch.ops import epilogue

    b16, cl = torch.bfloat16, torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(21)
    mk = dict(generator=gen, device="cuda")
    out = {"card": card, "shapes": {}, "max_abs_err": 0.0}
    for name, shape, up, act, act_first in EPILOGUE_SHAPES:
        n, c, h, w = shape
        src = torch.randn((n, c, h >> up, w >> up), **mk).to(b16).contiguous(memory_format=cl)
        skip = torch.randn(shape, **mk).to(b16).contiguous(memory_format=cl)
        args = (src, torch.randn(c, **mk).to(b16), skip, up, act, act_first)
        got, ref = epilogue.bias_act_cuda(*args), epilogue.bias_act_plain(*args)
        err = float((got.float() - ref.float()).abs().max())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            fail(f"epilogue kernel differs from its plain version at {name} (max abs {err})")
        moved = (src.numel() + skip.numel() + got.numel() + c) * 2
        out["shapes"][name] = {
            "shape": list(shape), "up": up, "act": act, "act_first": act_first,
            "ms": queued_ms(lambda: epilogue.bias_act_cuda(*args)),
            "plain_ms": queued_ms(lambda: epilogue.bias_act_plain(*args)),
            "max_abs_err": err, **bound(moved, 4 * got.numel(), H100_F32_OPS_PER_S)}
        del src, skip, args, got, ref
        torch.cuda.empty_cache()
    out["cudnn_fused"] = cudnn_fused_conv(torch, gen, epilogue)
    return out


def phase_vitpose(th, torch, gen, card):
    """Phase 22: ViTPose-H on the main path at `vitpose-h-clip32`'s shapes:
    (a) the head's transposed convs and their epilogue, (b) K1 at 64x48,
    (c) the launches of one clip (VITPOSE_LAUNCHES)."""
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.models.layers import deconv_out, finish, fold_batchnorm
    from tpupose_torch.models.vitpose import vitpose_h_config, vitpose_init
    from tpupose_torch.models.yolov3 import YoloConfig, yolov3_init
    from tpupose_torch.ops import attention, epilogue
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking.tracker import TrackerConfig

    t_phase = time.perf_counter()
    cfg = vitpose_h_config()
    with torch.device("cuda"):
        pose = vitpose_init(cfg, torch.Generator(device="cuda").manual_seed(22))
    pose = fold_batchnorm(jitter_bn(torch, pose, gen), dtype=torch.bfloat16)
    out = {"card": card, "config": "YOLOv3-416 (max_candidates=4) + ViTPose-H 256x192, "
                                   "BN folded, bf16; 32 frames x 5 views x 776x1032 uint8"}

    # (a) the head's transposed convs on the backbone's features of 640 crops
    crops = torch.randn((MAIN_CROPS, 3, *cfg.input_size), generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    heads, seq = [], pose.keypoint_head.deconv_layers
    with torch.no_grad():
        x = pose.backbone(crops)
        for i in range(0, len(seq), 3):
            conv = deconv_out(seq[i], seq[i + 1], x)
            if not (conv.fused and conv.y.is_contiguous(memory_format=torch.channels_last)):
                fail(f"ViTPose head: the transposed conv {i} gave a {tuple(conv.y.shape)} "
                     f"output the epilogue does not serve (fused={conv.fused})")
            before = epilogue.launches
            got = finish(conv, act="relu")
            ref = epilogue.bias_act_plain(conv.y, conv.bias, act="relu")
            if epilogue.launches - before != 1:
                fail(f"ViTPose head: the transposed conv {i}'s epilogue took the composed ops")
            err = float((got.float() - ref.float()).abs().max())
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                fail(f"ViTPose head: the epilogue differs from its plain version after the "
                     f"transposed conv {i} (max abs {err})")
            heads.append({"layer": f"deconv_layers.{i}", "shape": list(got.shape),
                          "max_abs_err": err})
            x = got
    out["head_epilogue"] = heads
    del crops, x, got, ref, conv
    torch.cuda.empty_cache()

    # (b) K1 at ViTPose's heatmap size
    out["k1"] = phase_kernel(th, torch, gen, (MAIN_CROPS, cfg.num_joints, *cfg.heatmap_size))

    # (c) one clip through the served path, launches counted from 0
    views, frames, height, width = 5, 32, 776, 1032
    det_cfg = YoloConfig(max_candidates=4)
    tcfg = TrackerConfig(num_cameras=views, max_dets=4, max_tracks=12, max_hyp=24)
    detector = fold_batchnorm(yolov3_init(det_cfg, torch.Generator().manual_seed(0)),
                              dtype=torch.bfloat16)
    scene = make_scene(num_frames=1, num_cameras=views, num_actors=3, seed=0)
    pipe = Pipeline(make_camera_set(scene.P, scene.K, scene.RT, width, height), tcfg, det_cfg,
                    detector, cfg, pose)
    clip = torch.randint(0, 256, (frames, views, height, width, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    frame_ids = torch.arange(frames, dtype=torch.int32)
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()
    th.launches = epilogue.launches = attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs, dets, mask = pipe.process_clip(frame_ids, clip)
    torch.cuda.synchronize()
    launches = {"epilogue.launches": epilogue.launches, "attention.launches": attention.launches,
                "heatmap.launches": th.launches}
    if launches != VITPOSE_LAUNCHES:
        fail(f"a ViTPose-H clip launched {launches}, expected {VITPOSE_LAUNCHES}")
    check_clip_outputs(torch, outs, dets, mask, frames, views, tcfg)
    out.update(launches=launches, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               detections_valid=int(mask.sum()), seconds=time.perf_counter() - t_phase)
    return out


def phase_hrformer(th, torch, gen, card):
    """Phase 23: HRFormer-B on the main path at `hrformer-b-clip32`'s
    shapes: (a) the epilogue's GELU at branch 0's FFN, (b) the launches of
    one clip (HRFORMER_LAUNCHES)."""
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.models.hrformer import hrformer_b_config, hrformer_init
    from tpupose_torch.models.layers import conv_out, finish, fold_batchnorm
    from tpupose_torch.models.yolov3 import YoloConfig, yolov3_init
    from tpupose_torch.ops import attention, epilogue
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking.tracker import TrackerConfig

    t_phase = time.perf_counter()
    cfg = hrformer_b_config()
    with torch.device("cuda"):
        pose = hrformer_init(cfg, torch.Generator(device="cuda").manual_seed(23))
    pose = fold_batchnorm(jitter_bn(torch, pose, gen), dtype=torch.bfloat16)
    with torch.no_grad():
        for m in pose.modules():  # live conv biases: the folded BN shifts and the FFN's own
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.add_(torch.randn(m.bias.shape, generator=gen, device="cuda").to(
                    m.bias.dtype), alpha=0.1)
    out = {"card": card, "config": "YOLOv3-416 (max_candidates=4) + HRFormer-B 384x288, "
                                   "BN folded, bf16; 32 frames x 5 views x 776x1032 uint8"}

    # (a) branch 0's FFN of the first block over 640 crops, each conv's epilogue
    ffn = pose.backbone.stage2[0].branches[0][0].ffn
    h, w = cfg.heatmap_size
    c = cfg.branch_channels[0]
    x = (2 * torch.randn((MAIN_CROPS, c, h, w), generator=gen, device="cuda")).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    skip = torch.randn((MAIN_CROPS, c, h, w), generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    rows = []
    with torch.no_grad():
        y = x
        for name, bn, kw in (("fc1", ffn.norm1, {}), ("dw3x3", ffn.norm2, {}),
                             ("fc2", ffn.norm3, {"skip": skip, "act_first": True})):
            conv = conv_out(getattr(ffn, name), bn, y, any_width=True)
            if not conv.fused or conv.bias is None:
                fail(f"HRFormer FFN: {name}'s output is not served by the epilogue "
                     f"(fused={conv.fused})")
            before = epilogue.launches
            got = finish(conv, act="gelu", **kw)
            ref = epilogue.bias_act_plain(conv.y, conv.bias, act="gelu", **kw)
            torch.cuda.synchronize()
            if epilogue.launches - before != 1:
                fail(f"HRFormer FFN: {name}'s epilogue took the composed ops")
            ulps = int((got.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max())
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                fail(f"HRFormer FFN: the GELU epilogue differs from the composed passes after "
                     f"{name} by up to {ulps} bf16 ulps")
            rows.append({"layer": name, "shape": list(got.shape), "max_ulps": ulps})
            y = got
    out["ffn_epilogue"] = rows
    del x, skip, y, got, ref, conv
    torch.cuda.empty_cache()

    # (b) one clip through the served path, launches counted from 0
    views, frames, height, width = 5, 32, 776, 1032
    det_cfg = YoloConfig(max_candidates=4)
    tcfg = TrackerConfig(num_cameras=views, max_dets=4, max_tracks=12, max_hyp=24)
    detector = fold_batchnorm(yolov3_init(det_cfg, torch.Generator().manual_seed(0)),
                              dtype=torch.bfloat16)
    scene = make_scene(num_frames=1, num_cameras=views, num_actors=3, seed=0)
    pipe = Pipeline(make_camera_set(scene.P, scene.K, scene.RT, width, height), tcfg, det_cfg,
                    detector, cfg, pose)
    clip = torch.randint(0, 256, (frames, views, height, width, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    frame_ids = torch.arange(frames, dtype=torch.int32)
    pipe.process_clip(frame_ids, clip)  # warm-up
    torch.cuda.synchronize()
    th.launches = epilogue.launches = attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs, dets, mask = pipe.process_clip(frame_ids, clip)
    torch.cuda.synchronize()
    launches = {"epilogue.launches": epilogue.launches, "attention.launches": attention.launches,
                "heatmap.launches": th.launches}
    if launches != HRFORMER_LAUNCHES:
        fail(f"an HRFormer-B clip launched {launches}, expected {HRFORMER_LAUNCHES}")
    check_clip_outputs(torch, outs, dets, mask, frames, views, tcfg)
    out.update(launches=launches, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               detections_valid=int(mask.sum()), seconds=time.perf_counter() - t_phase)
    return out


def phase_train(torch, card):
    """Phase 13: HRNet-W48 384x288 training at full width on blob batches,
    every step a captured CUDA graph after its warm-ups: (a) the JAX
    default recipe with save / resume (d) at RESUME_AT, (b) the JAX
    package's learning recipe, each also held against its eager body and
    timed eagerly; (c) the tiny config card vs CPU, (e) a learned tiny
    model. Returns the report and (b)'s model and last batch for phase
    14."""
    import tempfile

    import numpy as np

    from tpupose_torch.models import train as tt
    from tpupose_torch.models.hrnet import hrnet_w48_config

    cfg = hrnet_w48_config()
    out = {"card": card, "config": f"HRNet-W48 384x288, blob batches of {TRAIN_BATCH}",
           "tf32": bool(torch.backends.cudnn.allow_tf32)}

    # (a) make_optimizer(), bf16, train_bn=False, one batch; (d) at RESUME_AT
    model, opt, step = w48_recipe(torch, tt, cfg, "a")
    batches = blob_batches(tt, np.random.default_rng(0), cfg, TRAIN_BATCH, fixed=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = train_steps(torch, step, batches, RESUME_AT)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory() as root:
        resume = check_resume(torch, tt, model, opt, step, next(batches), root)
    more_losses, more_ms = train_steps(torch, step, batches,
                                       TRAIN_STEPS - RESUME_AT - RESUME_STEPS)
    losses += [a for a, _ in resume["next_step_losses"]] + more_losses
    ms += [None] * RESUME_STEPS + more_ms  # the resumed steps ran with cuDNN deterministic
    if not losses[-1] < losses[0]:
        fail(f"W48 training (a): the loss went from {losses[0]} to {losses[-1]}")
    timed = [t for t in ms[TRAIN_TIMED_FROM - 1:] if t is not None]
    captured = capture_report(torch, step, next(batches))
    out["a"] = {"recipe": "make_optimizer() (AdamW 1e-3, wd 1e-4, capturable), bf16, "
                          "train_bn=False, one batch", "steps": TRAIN_STEPS, "losses": losses,
                "step_ms": ms, "ms_per_step": statistics.median(timed), "peak_mem_gib": peak,
                "captured": captured}
    out["d"] = resume
    del model, opt, step
    torch.cuda.empty_cache()
    out["a"]["against_eager"] = graphed_against_eager(
        torch, tt, lambda: w48_recipe(torch, tt, cfg, "a"), [next(batches)] * TRAIN_STEPS,
        "W48 training (a)")

    # (b) the JAX package's learning recipe: Adam 1e-3, f32, train_bn, fresh batches
    torch.cuda.empty_cache()
    batches = blob_batches(tt, np.random.default_rng(1), cfg, TRAIN_BATCH, scale=10.0)
    fresh = [next(batches) for _ in range(TRAIN_STEPS)]
    model, opt, step = w48_recipe(torch, tt, cfg, "b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = train_steps(torch, step, iter(fresh), TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_losses, tf32_ms = train_steps(torch, step, batches, TF32_STEPS)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    captured = capture_report(torch, step, next(batches))  # keys: TF32 off, on
    ms_b = timed_median(ms)
    out["b"] = {"recipe": "Adam 1e-3 (capturable), f32, train_bn=True, a fresh batch per "
                          "step, targets x 10 (scripts/int8_w48_agreement.py:395-414)",
                "steps": TRAIN_STEPS, "losses": losses, "step_ms": ms, "ms_per_step": ms_b,
                "peak_mem_gib": peak, "extrapolated_4000_steps_s": 4000 * ms_b / 1e3,
                "captured": captured, "tf32_steps": TF32_STEPS, "tf32_losses": tf32_losses,
                "tf32_step_ms": tf32_ms, "tf32_ms_per_step": statistics.median(tf32_ms[3:])}
    last_batch = next(batches)
    del opt, step
    torch.cuda.empty_cache()
    out["b"]["against_eager"] = graphed_against_eager(
        torch, tt, lambda: w48_recipe(torch, tt, cfg, "b"), fresh, "W48 training (b)")
    out["b"]["eager_extrapolated_4000_steps_s"] = (
        4000 * out["b"]["against_eager"]["eager_ms_per_step"] / 1e3)
    del fresh
    torch.cuda.empty_cache()

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
    waits on the card, nor the launch queue on it). If a sleep ends before
    its batch was submitted, every batch so far is dropped and the whole
    measurement starts again behind sleeps twice as long, so that all the
    batches counted ran under one sleep; fails past a 1 s sleep."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * SLEEP_HZ))
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    estimate = (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    sleep_s = 2 * HOST_BATCH * estimate + 0.01
    while True:
        total = 0.0
        for _ in range(HOST_CALLS // HOST_BATCH):
            torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
            busy = torch.cuda.Event()
            busy.record()
            t0 = time.perf_counter()
            for _ in range(HOST_BATCH):
                fn()
            total += time.perf_counter() - t0
            covered = not busy.query()
            torch.cuda.synchronize()
            if not covered:
                break
        else:
            return total / HOST_CALLS * 1e6
        sleep_s *= 2  # the host was slower than the sleep: start again
        if sleep_s > 1.0:
            fail("host_us: the host could not submit its calls within a 1 s sleep")


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
    """(c): S streams of different scenes through the (graphed) multistream
    step, every stream held to its own single-stream `track_clip` on the
    card."""
    from tpupose_torch.ops import lap
    from tpupose_torch.parallel import (
        broadcast_cameras,
        init_multistream_state,
        make_multistream_step_fn,
    )
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
        step = make_multistream_step_fn(cfg)
        for s in MS_STREAMS:
            cams_s = broadcast_cameras(cams, s)
            with torch.inference_mode():  # warm-up and capture, outside the timing
                step(cams_s, init_multistream_state(cfg, s), dets[:s, 0], mask[:s, 0],
                     fids[0].expand(s))
            state = init_multistream_state(cfg, s)
            lap.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = []
            with torch.inference_mode(), no_syncs(torch):
                for t in range(MS_FRAMES):
                    state, o = step(cams_s, state, dets[:s, t], mask[:s, t], fids[t].expand(s))
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
    from tpupose_torch.ops import epilogue
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import int8_conv as k2
    from tpupose_torch.ops import lap
    from tpupose_torch.parallel import (
        broadcast_cameras,
        init_multistream_state,
        make_multistream_clip_fn,
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
    # K1, K2, K2a, the epilogue: one stage-A batch a chunk; K3: one
    # association and one init LAP a camera, a step
    expect = {mode: {"k1": n_chunks * c["heatmap.launches"],
                     "k2": n_chunks * c["int8_conv.launches"],
                     "k2a": n_chunks * c["int8_conv.quantize_launches"],
                     "k2_stem": n_chunks * c["int8_conv.stem_launches"],
                     "k2b_requant": n_chunks * c["int8_conv.requant_launches"],
                     "k2b_halo": n_chunks * c["int8_conv.halo_launches"],
                     "epilogue": n_chunks * c["epilogue.launches"],
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
            k2.requant_launches = k2.halo_launches = lap.launches = epilogue.launches = 0
            before = set(card_steps())
            with counted_syncs() as counted, nchw_conv_inputs(torch, det_m, pose_m) as layouts:
                states, outs = fn(det_m, pose_m, broadcast_cameras(cams, s),
                                  init_multistream_state(tcfg, s), clip, fids)
            torch.cuda.synchronize()
        finally:
            throughput._clip_detections = inner
        check_channels_last(layouts, f"multistream clip ({mode})")
        launches = {"k1": th.launches, "k2": k2.launches, "k2a": k2.quantize_launches,
                    "k2_stem": k2.stem_launches, "k2b_requant": k2.requant_launches,
                    "k2b_halo": k2.halo_launches, "epilogue": epilogue.launches,
                    "k3": lap.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        # a graph captured in this run ran its warm-up's K3 launches too
        warmup = graph_k3_warmups(before)
        if launches != {**expect[mode], "k3": expect[mode]["k3"] + warmup}:
            fail(f"multistream clip ({mode}) launched {launches}, expected {expect[mode]} "
                 f"and {warmup} K3 launches of a capture's warm-up")
        dets = torch.cat([d.reshape(s, -1, views, 4, 17, 3) for d, _ in stage_a], dim=1)
        mask = torch.cat([m.reshape(s, -1, views, 4) for _, m in stage_a], dim=1)
        if tuple(outs.pose3d.shape) != (s, f, 12, 17, 3) or not (
                torch.isfinite(dets).all() and torch.isfinite(outs.pose3d).all()):
            fail(f"multistream clip ({mode}): shapes {tuple(outs.pose3d.shape)} or non-finite")
        # each stream's stage B against track_clip fed its own detections
        with torch.inference_mode():
            for i in range(s):
                _, ref = track_clip(tcfg, cams, init_state(tcfg, "cuda"), dets[i], mask[i], fids[i])
                for field in ("track_id", "valid", "n_views", "pose2d_now"):
                    if not torch.equal(getattr(outs, field)[i], getattr(ref, field)):
                        fail(f"multistream clip ({mode}) stream {i}: {field} differs from "
                             f"track_clip on its stage-A detections")
        run = {"launches": launches, "k3_warmup_launches": warmup, "peak_mem_gib": peak,
               "host_syncs": counted["syncs"], "detections_valid": int(mask.sum()),
               "conv_inputs": layouts}
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


GRAPH_FRAMES = 64        # (a): frames of the single step, graphed against eager
GRAPH_MS_FRAMES = 32     # (b): frames of the multistream step at each S
GRAPH_POSE_TOL = 5e-3    # metres, tests/test_tracker_parity.py's band, if not bit-equal


def graph_scene(num_frames, seed):
    """The continuous adversarial stream with a false positive a view and
    drops: the step's matching, update and init paths on every frame."""
    from tpupose_torch.data.synthetic import make_continuous_adversarial_scene

    return make_continuous_adversarial_scene(num_frames=num_frames, num_cameras=5,
                                             num_actors=3, noise_px=1.5, fp_per_view=1,
                                             drop_prob=0.2, seed=seed)


def card_steps():
    """{key: CapturedStep} of the steps captured on a card."""
    from tpupose_torch.runtime import graphs

    return {k: s for k, s in graphs.steps().items() if s.device.type == "cuda"}


def card_replays():
    """Replays of every graph on a card so far."""
    return sum(s.replays for s in card_steps().values())


def card_step(tag, cfg, dets_shape):
    """The card's CapturedStep of `tag` ("tracker_step" or
    "multistream_step") at `cfg` whose detections have `dets_shape`."""
    found = [s for ((t, c), _, signature, _), s in card_steps().items()
             if t == tag and c == cfg and tuple(signature[-2][0]) == tuple(dets_shape)]
    if len(found) != 1:
        fail(f"{len(found)} graphs of {tag} at detections {tuple(dets_shape)}, expected 1")
    return found[0]


def graph_k3_warmups(before):
    """K3 launches of the warm-ups of the graphs captured since `before`
    (a set of keys): real launches inside a counted window."""
    return sum(s.warmup_launches[0] for k, s in card_steps().items() if k not in before)


def mismatches(torch, got, ref, what):
    """[(what.field, max |difference| or "differs")] of two NamedTuples."""
    out = []
    for name, a, b in zip(ref._fields, got, ref):
        if not torch.equal(a, b):
            diff = (float((a.double() - b.double()).abs().max())
                    if a.dtype.is_floating_point else "differs")
            out.append((f"{what}.{name}", diff))
    return out


def gate_mismatches(found, where):
    """Not bit-equal: the discrete fields must still be equal and the
    poses within GRAPH_POSE_TOL; returns the report."""
    discrete = [m for m in found if not isinstance(m[1], float)]
    worst = max((m[1] for m in found if isinstance(m[1], float)), default=0.0)
    if discrete or worst > GRAPH_POSE_TOL:
        fail(f"{where}: the graphed step differs from the eager step: {found[:8]}")
    return {"bit_equal": False, "first": found[:8], "float_max_abs_diff": worst}


def busy_and_window(events):
    """µs the profiled device events cover (the union of their intervals),
    and the window from the first start to the last end."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return busy, max(e for _, e in spans) - spans[0][0]


def profiled_device_events(torch, fn):
    """Device events of fn() under torch.profiler: (count, memcpy/memset
    count, busy µs as the union of their intervals, window µs from the
    first start to the last end), or the error as a string."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_events(torch, prof)
    except Exception as e:  # a machine may refuse CUPTI: report, do not gate
        return f"not measured: {type(e).__name__}: {e}"
    if not events:
        return "not measured: the profiler recorded no device events"
    busy, window = busy_and_window(events)
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in events)
    return {"device_events": len(events), "memcpy_memset": copies, "busy_us": busy,
            "window_us": window, "idle_share": 1.0 - busy / window if window > 0 else 0.0}


def host_us_behind_sleep(torch, fn, n, sleep_s=0.2):
    """The host's time for one fn() while the card sleeps (nothing waits on
    it), in µs, over n calls."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
    busy = torch.cuda.Event()
    busy.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    covered = not busy.query()
    torch.cuda.synchronize()
    if not covered:
        fail(f"host time: {n} calls outlasted a {sleep_s} s sleep")
    return host / n * 1e6


def device_ms_behind_sleep(torch, fn, sleep_s=0.2):
    """The card's time for fn()'s work alone, in ms: events around it,
    queued behind a sleep longer than its submission."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    covered = not start.query()
    end.synchronize()
    if not covered:
        fail(f"device time: the submission outlasted a {sleep_s} s sleep")
    return start.elapsed_time(end)


def eager_clip(torch, cfg, cams, state, dets, mask, fids):
    """The eager stage B: `tracker_step` a frame, stacked."""
    from tpupose_torch.tracking.tracker import stack_outputs, tracker_step

    outs = []
    for t in range(dets.shape[0]):
        state, out = tracker_step(cfg, cams, state, dets[t], mask[t], fids[t])
        outs.append(out)
    return state, stack_outputs(outs)


def graphed_single(torch, caps):
    """(a) at one capacity set: make_step_fn and track_clip against the
    eager step, and the graph."""
    from tpupose_torch.tracking.tracker import (
        init_state,
        make_step_fn,
        track_clip,
        tracker_step,
    )

    dets, mask, fids, cams, cfg = stream_inputs(torch, graph_scene(GRAPH_FRAMES, 1), caps,
                                                "cuda")
    found, out = [], {}
    with torch.inference_mode():
        before = set(card_steps())
        step = make_step_fn(cfg)
        e_state = g_state = init_state(cfg, "cuda")
        g_state, g_out = step(cams, g_state, dets[0], mask[0], fids[0])  # the capture
        captured = card_step("tracker_step", cfg, dets.shape[1:])
        out["captured_here"] = len(card_steps()) > len(before)
        e_state, e_out = tracker_step(cfg, cams, e_state, dets[0], mask[0], fids[0])
        for t in range(GRAPH_FRAMES):
            if t:
                e_state, e_out = tracker_step(cfg, cams, e_state, dets[t], mask[t], fids[t])
                g_state, g_out = step(cams, g_state, dets[t], mask[t], int(t))
            found += mismatches(torch, g_state, e_state, f"frame {t} state")
            found += mismatches(torch, g_out, e_out, f"frame {t} output")
        confirmed = int(e_out.valid.sum())
        e_final, e_outs = eager_clip(torch, cfg, cams, init_state(cfg, "cuda"), dets, mask, fids)
        g_final, g_outs = track_clip(cfg, cams, init_state(cfg, "cuda"), dets, mask, fids)
        found += mismatches(torch, g_final, e_final, "track_clip final state")
        found += mismatches(torch, g_outs, e_outs, "track_clip outputs")
    out["compare"] = ({"bit_equal": True} if not found else
                      gate_mismatches(found, f"graphs at {caps}"))
    out["confirmed_tracks_last_frame"] = confirmed
    if confirmed < 2:
        fail(f"graphs at {caps}: the scene confirmed {confirmed} tracks")
    out["graph"] = captured.stats()
    return out


def graphed_multistream(torch):
    """(b): make_multistream_step_fn against the eager vmapped step at each
    S and capacity set, S streams of different scenes."""
    from tpupose_torch.parallel import (
        broadcast_cameras,
        init_multistream_state,
        make_multistream_step_fn,
        multistream_step,
    )

    scenes = [graph_scene(GRAPH_MS_FRAMES, seed) for seed in range(1, max(MS_STREAMS) + 1)]
    out = {}
    for name, caps in MS_CAPS.items():
        inputs = [stream_inputs(torch, sc, caps, "cuda") for sc in scenes]
        cams, cfg, fids = inputs[0][3], inputs[0][4], inputs[0][2]
        dets = torch.stack([x[0] for x in inputs])
        mask = torch.stack([x[1] for x in inputs])
        step = make_multistream_step_fn(cfg)
        runs = {}
        for s in MS_STREAMS:
            cams_s = broadcast_cameras(cams, s)
            found = []
            before = set(card_steps())
            for _ in range(2):  # the first graphed run captures, the second replays
                e_states, e_outs, g_states, g_outs = [], [], [], []
                for kind, fn in (("eager", lambda *a: multistream_step(cfg, *a)),
                                 ("graphed", step)):
                    state = init_multistream_state(cfg, s)
                    with torch.inference_mode():
                        for t in range(GRAPH_MS_FRAMES):
                            state, o = fn(cams_s, state, dets[:s, t], mask[:s, t],
                                          fids[t].expand(s))
                            (e_states if kind == "eager" else g_states).append(state)
                            (e_outs if kind == "eager" else g_outs).append(o)
                for t in range(GRAPH_MS_FRAMES):
                    found += mismatches(torch, g_states[t], e_states[t], f"S={s} frame {t} state")
                    found += mismatches(torch, g_outs[t], e_outs[t], f"S={s} frame {t} output")
            captured = card_step("multistream_step", cfg, (s,) + tuple(dets.shape[2:]))
            runs[s] = {"captured_here": len(card_steps()) > len(before),
                       "compare": ({"bit_equal": True} if not found else
                                   gate_mismatches(found, f"multistream graphs at {name}, S={s}")),
                       "graph": captured.stats()}
        out[name] = runs
    return out


def phase_graphs(torch, card):
    """Phase 19: the tracker step as a captured CUDA graph (see the module
    docstring)."""
    t_phase = time.perf_counter()
    single = {name: graphed_single(torch, caps) for name, caps in MS_CAPS.items()}
    emit("graphs_single", card=card, **single)
    multistream = graphed_multistream(torch)
    emit("graphs_multistream", card=card, **multistream)
    return {"card": card, "single": single, "multistream": multistream,
            "seconds": time.perf_counter() - t_phase}


def graphs_summary():
    """Every graph captured on the card in this run: its step, capacities
    (max_dets, max_tracks, max_hyp), detections' shape, and its figures."""
    return [{"fn": tag, "capacities": [cfg.max_dets, cfg.max_tracks, cfg.max_hyp],
             "dets_shape": list(signature[-2][0]), **s.stats()}
            for ((tag, cfg), _, signature, _), s in card_steps().items()]


#: (a): crops per data rank; steps: WARMUP eager, the capture, replays
PAR_TRAIN_BATCH, PAR_TRAIN_STEPS, PAR_TRAIN_LR = 8, 6, 1e-3
PAR_STREAMS_PER_CARD, PAR_FRAMES = 2, 32                     # (b)
SMALL_COLLECTIVE_WARMUP, SMALL_COLLECTIVE_CALLS = 20, 200    # (a): one small collective's cost
PAR_TIMEOUT_S = 420  # every rank's whole run, the spawn included
#: (a)'s gates against rank 0's unsharded step, both graphed after their
#: warm-ups. With one data rank the sharded step computes what the
#: unsharded one does, op for op (the synchronized BN's merge over one rank
#: of share 1 is the identity): losses, gradients and parameters equal bit
#: for bit. With more, the batch is summed in
#: parts, and train-mode BN's gradients are ill-conditioned where a
#: channel's mean dwarfs its spread (a last-bit change moves a tensor's
#: gradient by up to 1e-2), so the sharded and the unsharded f32 gradients
#: are each held to the same gradient in f64: the first loss within
#: PAR_LOSS_RTOL, the sharded gradient's relative norm from the f64 one
#: within PAR_GRAD_F64_RATIO x the unsharded one's, and every parameter
#: within Adam's bound of 2 x lr a step (Adam's first steps move an entry
#: by at most about lr whatever its gradient) plus PAR_F32_SLACK, the f32
#: rounding of parameters of magnitude up to 8; the share of entries outside
#: PAR_PARAM_RTOL plus PAR_PARAM_ATOL_LR x lr is reported, not gated.
PAR_LOSS_RTOL, PAR_GRAD_F64_RATIO, PAR_F32_SLACK = 1e-5, 2.0, 1e-6
PAR_PARAM_RTOL, PAR_PARAM_ATOL_LR = 1e-5, 1e-2


def held_entries(t, mesh, spec):
    """The rows of a whole tensor that this rank holds under `spec`."""
    if not spec:
        return t
    k = t.shape[0] // mesh.shape["model"]
    return t[mesh.model_index * k:(mesh.model_index + 1) * k]


def rel_norm(torch, got, ref):
    """||got - ref|| / ||ref|| over every entry of two {name: tensor} sets."""
    err = sum(float(torch.linalg.vector_norm(got[n] - r)) ** 2 for n, r in ref.items())
    den = sum(float(torch.linalg.vector_norm(r)) ** 2 for r in ref.values())
    return (err / den) ** 0.5


@contextlib.contextmanager
def f64_batch_statistics(torch):
    """Train-mode BN statistics in the input's own dtype (f64 for an f64
    model) inside the block, as tests/test_torch_train.py's f64 reference."""
    from tpupose_torch.models import layers

    def observe(self, bn, x):
        m = x.mean(dim=(0, 2, 3))
        v = torch.square(x - m[:, None, None]).mean(dim=(0, 2, 3))
        self.taps.append((bn, m, v))
        return m, v

    inner, layers.BNStatRecorder.observe = layers.BNStatRecorder.observe, observe
    try:
        yield
    finally:
        layers.BNStatRecorder.observe = inner


def param_agreement(torch, got, ref, lr):
    """Entry-wise agreement of two {name: tensor} parameter sets: the
    entries outside PAR_PARAM_RTOL, and outside it plus PAR_PARAM_ATOL_LR x
    lr, the largest differences, and whether they are equal."""
    atol = PAR_PARAM_ATOL_LR * lr
    worst_abs = worst_rel = 0.0
    outside = outside_rtol = entries = 0
    equal = True
    for name, r in ref.items():
        equal = equal and torch.equal(got[name], r)
        diff = (got[name] - r).abs()
        entries += r.numel()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / r.abs().clamp_min(1e-30)).max()))
        outside_rtol += int((diff > PAR_PARAM_RTOL * r.abs()).sum())
        outside += int((diff > PAR_PARAM_RTOL * r.abs() + atol).sum())
    return {"entries": entries, "outside_rtol": outside_rtol, "outside_rtol_atol": outside,
            "max_abs_diff": worst_abs, "max_rel_diff": worst_rel, "equal": equal}


def sharded_everything(step):
    """{name: tensor} of a sharded step's local trained tensors, their
    `.grad` and their optimizer state, copies on the card."""
    out = {}
    for name, t in step.tensors.items():
        out[name] = t.detach().clone()
        out[name + ".grad"] = t.grad.clone()
        for k, v in step.optimizer.state[t].items():
            out[f"{name}.{k}"] = v.clone()
    return out


def small_collective_us(torch, collective):
    """The host's µs for one small collective, back to back after
    SMALL_COLLECTIVE_WARMUP, to a sync."""
    for k in range(SMALL_COLLECTIVE_WARMUP + SMALL_COLLECTIVE_CALLS):
        if k == SMALL_COLLECTIVE_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        collective()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / SMALL_COLLECTIVE_CALLS


def parallel_train(torch, mesh):
    """(a): `make_sharded_train_step` on HRNet-W48 384x288, phase 13 (b)'s
    recipe: graphed (2 warm-ups, the capture, replays), then its eager body
    from the same weights on the same batches, equal bit for bit; then rank
    0's unsharded `make_train_step` on the whole global batch, graphed too,
    against the graphed sharded step."""
    import numpy as np

    from tpupose_torch.models import train as tt
    from tpupose_torch.models.hrnet import hrnet_init, hrnet_w48_config
    from tpupose_torch.parallel import shard_batch
    from tpupose_torch.runtime.graphs import WARMUP

    cfg = hrnet_w48_config()
    d, m = mesh.shape["data"], mesh.shape["model"]
    model = hrnet_init(cfg, torch.Generator().manual_seed(23)).cuda()
    n_bn = sum(isinstance(x, torch.nn.BatchNorm2d) for x in model.modules())
    batches = blob_batches(tt, np.random.default_rng(1), cfg, PAR_TRAIN_BATCH * d, scale=10.0)
    global_batches = [next(batches) for _ in range(PAR_TRAIN_STEPS)]
    local_batches = [shard_batch(mesh, b) for b in global_batches]

    def build():
        return tt.make_sharded_train_step(
            model, lambda ts: torch.optim.Adam(ts, lr=PAR_TRAIN_LR, capturable=True), mesh,
            torch.float32, train_bn=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step, shardings_for = build()
    specs = step.specs
    losses, ms, gathered, snaps, collectives = [], [], [], [], []
    for i, local in enumerate(local_batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*local)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        collectives.append(dict(step.collectives))
        snaps.append(sharded_everything(step))
        if i == 0:
            grads = {n: t.grad.to("cpu", copy=True) for n, t in step.tensors.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
        gathered.append(step.gather())  # copies, kept on the card
    steady = {"all_reduces": 1, "all_gathers": 1 + n_bn, "reduce_scatters": n_bn}
    first = dict(steady, all_gathers=2 + n_bn)  # the new key's batch-size all-gather
    (key,) = step.stats()
    expected = [first] + [steady] * (PAR_TRAIN_STEPS - 1)
    if collectives != expected or key["held_collectives"] != steady:
        fail(f"sharded training: collectives {collectives}, the graph holds "
             f"{key['held_collectives']}; expected {first}, then {steady} a step ({n_bn} BNs)")
    host_us = host_us_behind_sleep(torch, lambda: step(*local_batches[-1]), n=HOST_REPLAYS)
    device_ms = device_ms_behind_sleep(torch, lambda: step(*local_batches[-1]))
    stats = step.stats()[0]
    graphed = {"step_ms": ms, "ms_per_step": statistics.median(ms[WARMUP + 1:]),
               "peak_mem_gib_first_step": peak, "capture_s": stats["capture_s"],
               "pool_mib": stats["pool_bytes"] / 2**20, "graph_nodes": stats["graph_nodes"],
               "replays": stats["replays"], "host_us_per_replay": host_us,
               "device_ms_per_replay": device_ms}
    small = torch.zeros(3, 48, device=mesh.device)
    rows = small.new_empty(d, 3, 48)
    small_us = {"all_reduce": small_collective_us(
        torch, lambda: torch.distributed.all_reduce(small, group=mesh.data_group)),
        "all_gather": small_collective_us(torch, lambda: torch.distributed.all_gather_into_tensor(
            rows.view(-1), small.view(-1), group=mesh.data_group))}
    held = sum(t.numel() * t.element_size() for t in step.tensors.values())
    adam = sum(v.numel() * v.element_size() for st in step.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v))
    full = dict(tt.named_trained_tensors(model))
    full_bytes = sum(t.numel() * t.element_size() for t in full.values())
    split = [n for n, spec in shardings_for(model).items() if spec]
    for name in split:
        t = step.tensors[name]
        st = step.optimizer.state[t]
        if not (t.shape[0] * m == st["exp_avg"].shape[0] * m == st["exp_avg_sq"].shape[0] * m
                == full[name].shape[0]):
            fail(f"sharded training: {name} holds {t.shape[0]} of {full[name].shape[0]} rows "
                 f"at model={m}")
    step.release()
    del step
    # the eager body from the same weights, on the same batches
    torch.cuda.reset_peak_memory_stats()
    eager, _ = build()
    eager_ms, bad = [], []
    for i, local in enumerate(local_batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = eager.eager(*local)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        now = sharded_everything(eager)
        bad += [f"{i}:loss"] * (not torch.equal(loss, losses[i]))
        bad += [f"{i}:{n}" for n, v in now.items() if not torch.equal(snaps[i][n], v)]
        del now
    eager_collectives = dict(eager.collectives)
    tensors_equal = len(snaps[0])
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    eager.release()
    del eager, snaps
    torch.cuda.empty_cache()
    if bad:
        fail(f"sharded training: the graphed step differs from its eager body under cuDNN "
             f"deterministic at {bad[:8]} ({len(bad)} in all)")
    losses = [float(x) for x in losses]
    out = {"mesh": mesh.shape, "global_batch": PAR_TRAIN_BATCH * d, "losses": losses,
           "nccl": list(torch.cuda.nccl.version()), "graphed": graphed,
           "eager": {"step_ms": eager_ms, "ms_per_step": statistics.median(eager_ms[1:]),
                     "peak_mem_gib": eager_peak, "collectives_per_step": eager_collectives},
           "graphed_equals_eager": {"steps": PAR_TRAIN_STEPS, "losses": PAR_TRAIN_STEPS,
                                    "tensors_a_step": tensors_equal,
                                    "cudnn_deterministic": True},
           "param_bytes_held": held, "adam_bytes_held": adam, "param_bytes_full": full_bytes,
           "split_tensors": len(split), "trained_tensors": len(full), "bns": n_bn,
           "collectives_per_step": {**steady, "total": sum(steady.values())},
           "collectives_first_step": first, "small_collective_us": small_us}
    if mesh.data_index == 0 and mesh.model_index == 0:
        def held_grads(named):  # this rank's entries of each gradient, f64, zeros for none
            return {n: torch.zeros(grads[n].shape, dtype=torch.float64) if t.grad is None
                    else held_entries(t.grad.detach().double().cpu(), mesh, specs[n])
                    for n, t in named}

        exact = copy.deepcopy(model).double()
        with f64_batch_statistics(torch):
            tt.heatmap_loss(exact, *(t.double() for t in global_batches[0]), torch.float64,
                            train_bn=True).backward()
        grads_f64 = held_grads(tt.named_trained_tensors(exact))
        del exact
        torch.cuda.empty_cache()
        ref_opt = torch.optim.Adam(tt.trained_tensors(model), lr=PAR_TRAIN_LR,
                                   capturable=True)
        ref_step = tt.make_train_step(model, ref_opt, torch.float32, train_bn=True)
        ref = {"losses": [], "step_ms": [], "steps": []}
        for i, batch in enumerate(global_batches):
            loss, ms_i = train_steps(torch, ref_step, iter([batch]), 1)
            ref["losses"] += loss
            ref["step_ms"] += ms_i
            named = {n: t.detach() for n, t in tt.named_trained_tensors(model)}
            agree = param_agreement(torch, gathered[i], named, PAR_TRAIN_LR)
            agree["loss_rtol"] = abs(losses[i] - loss[0]) / abs(loss[0])
            if i == 0:
                grads_ref = held_grads(tt.named_trained_tensors(model))
                sharded = {n: g.double() for n, g in grads.items()}
                agree.update(
                    grads_equal=all(torch.equal(grads[n], grads_ref[n].float()) for n in grads),
                    grad_rel_norm=rel_norm(torch, sharded, grads_ref),
                    grad_rel_norm_to_f64=rel_norm(torch, sharded, grads_f64),
                    unsharded_grad_rel_norm_to_f64=rel_norm(torch, grads_ref, grads_f64))
            ref["steps"].append(agree)
        ref["device_ms_per_replay"] = device_ms_behind_sleep(
            torch, lambda: ref_step(*global_batches[-1]))
        ref["replays"] = sum(k["replays"] for k in ref_step.stats())
        ref["limits"] = {"one_data_rank": "losses, gradients, parameters equal",
                         "loss_rtol_first_step": PAR_LOSS_RTOL,
                         "grad_rel_norm_to_f64": f"{PAR_GRAD_F64_RATIO} x the unsharded step's",
                         "param_max_abs_diff": [2 * PAR_TRAIN_LR * (i + 1) + PAR_F32_SLACK
                                                for i in range(PAR_TRAIN_STEPS)],
                         "reported": {"param_rtol": PAR_PARAM_RTOL,
                                      "param_atol": PAR_PARAM_ATOL_LR * PAR_TRAIN_LR}}
        out["reference"] = ref
        steps = ref["steps"]
        if d == 1:
            ok = (losses == ref["losses"] and steps[0]["grads_equal"]
                  and all(st["equal"] for st in steps))
        else:
            ok = (steps[0]["loss_rtol"] <= PAR_LOSS_RTOL
                  and steps[0]["grad_rel_norm_to_f64"]
                  <= PAR_GRAD_F64_RATIO * steps[0]["unsharded_grad_rel_norm_to_f64"]
                  and all(st["max_abs_diff"] <= 2 * PAR_TRAIN_LR * (i + 1) + PAR_F32_SLACK
                          for i, st in enumerate(steps)))
        # its steps after the warm-ups replayed, and the timed one
        if not ok or ref["replays"] != PAR_TRAIN_STEPS - WARMUP + 1:
            fail(f"sharded training against the unsharded step: {json.dumps(ref)}")
        ref_step.release()
        del ref_step, ref_opt
    del model, gathered
    torch.cuda.empty_cache()
    return out


def parallel_streams(torch, mesh):
    """(b): the multi-stream clip at full width over the 'data' ranks, each
    rank's streams held against their own single-stream stage B."""
    import numpy as np

    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.models.hrnet import hrnet_init, hrnet_w48_config
    from tpupose_torch.models.layers import fold_batchnorm, to_channels_last
    from tpupose_torch.models.yolov3 import YoloConfig, yolov3_init
    from tpupose_torch.ops import heatmap as th
    from tpupose_torch.ops import lap
    from tpupose_torch.parallel import (
        broadcast_cameras,
        init_multistream_state,
        make_multistream_clip_fn,
        make_multistream_step_fn,
        multihost,
        shard_streams,
        throughput,
    )
    from tpupose_torch.tracking.tracker import TrackerConfig, init_state, track_clip

    views, (height, width), f = 5, CLIP_HW, PAR_FRAMES
    total = PAR_STREAMS_PER_CARD * mesh.shape["data"]
    start, end = multihost.process_stream_slice(total, mesh)
    s = end - start
    det_cfg, pose_cfg = YoloConfig(max_candidates=4), hrnet_w48_config()
    tcfg = TrackerConfig(num_cameras=views, max_dets=4, max_tracks=12, max_hyp=24)
    cpu_gen = torch.Generator().manual_seed(0)
    # served channels-last, as `Pipeline` serves them
    detector = to_channels_last(
        fold_batchnorm(yolov3_init(det_cfg, cpu_gen), dtype=torch.bfloat16).cuda())
    pose = to_channels_last(
        fold_batchnorm(hrnet_init(pose_cfg, cpu_gen), dtype=torch.bfloat16).cuda())
    scene = make_scene(num_frames=1, num_cameras=views, num_actors=3, seed=0)
    cams = make_camera_set(scene.P, scene.K, scene.RT, width, height, device="cuda")
    cams_s = shard_streams(mesh, broadcast_cameras(cams, total))
    clip = torch.stack([torch.randint(
        0, 256, (f, views, height, width, 3), device="cuda", dtype=torch.uint8,
        generator=torch.Generator(device="cuda").manual_seed(1000 + i))
        for i in range(start, end)])
    fids = multihost.global_streams(
        mesh, np.arange(total * f, dtype=np.int32).reshape(total, f)[start:end])
    fn = make_multistream_clip_fn(det_cfg, pose_cfg, tcfg)
    fn(detector, pose, cams_s, shard_streams(mesh, init_multistream_state(tcfg, total)), clip,
       fids)  # warm-up
    chunk = throughput._auto_chunk(s, f, views)
    expect = {"k1": f // chunk * STEP_LAUNCHES["bf16"]["heatmap.launches"],
              "k3": f * (1 + views)}
    stage_a, inner = [], throughput._clip_detections

    def recording(*args):
        stage_a.append(inner(*args))
        return stage_a[-1]

    states = shard_streams(mesh, init_multistream_state(tcfg, total))
    torch.distributed.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    throughput._clip_detections = recording
    try:
        th.launches = lap.launches = 0
        t0 = time.perf_counter()
        states, outs = fn(detector, pose, cams_s, states, clip, fids)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"k1": th.launches, "k3": lap.launches}
    finally:
        throughput._clip_detections = inner
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != expect:
        fail(f"sharded multistream clip launched {launches}, expected {expect}")
    dets = torch.cat([dd.reshape(s, -1, views, 4, 17, 3) for dd, _ in stage_a], dim=1)
    mask = torch.cat([mm.reshape(s, -1, views, 4) for _, mm in stage_a], dim=1)
    if tuple(outs.pose3d.shape) != (s, f, 12, 17, 3) or not (
            torch.isfinite(dets).all() and torch.isfinite(outs.pose3d).all()):
        fail(f"sharded multistream clip: shapes {tuple(outs.pose3d.shape)} or non-finite")
    # the split, each stage alone to a sync
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for k in range(0, f, chunk):
            inner(det_cfg, pose_cfg, tcfg, detector, pose,
                  clip[:, k:k + chunk].reshape(-1, height, width, 3))
    torch.cuda.synchronize()
    stage_a_s = time.perf_counter() - t0
    state = shard_streams(mesh, init_multistream_state(tcfg, total))
    step = make_multistream_step_fn(tcfg, mesh, num_streams=total)  # this rank's graph
    replays = card_replays()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for t in range(f):
            state, _ = step(cams_s, state, dets[:, t], mask[:, t], fids[:, t])
    torch.cuda.synchronize()
    stage_b_s = time.perf_counter() - t0
    replays = card_replays() - replays
    if replays != f or not all(torch.equal(a, b) for a, b in zip(state, states)):
        fail(f"the mesh step: {replays} graph replays over {f} frames, or a final state "
             f"other than the clip function's")
    # each stream against its own single-stream stage B (phase 15 (c)'s check)
    with torch.inference_mode():
        for i in range(s):
            _, ref = track_clip(tcfg, cams, init_state(tcfg), dets[i], mask[i], fids[i])
            for field in ("track_id", "valid", "n_views", "pose2d_now"):
                if not torch.equal(getattr(outs, field)[i], getattr(ref, field)):
                    fail(f"sharded multistream clip, stream {start + i}: {field} differs "
                         f"from track_clip on its stage-A detections")
    own, own_dets = int(states.active.sum()), int(mask.sum())
    metric = multihost.all_hosts_metric(mesh, lambda st: st.active.sum())(states)
    metric_dets = multihost.all_hosts_metric(mesh, lambda m: m.sum())(mask)
    return {"mesh": mesh.shape, "streams": [start, end], "frames": f, "seconds": seconds,
            "fps": s * f / seconds, "stage_a_s": stage_a_s, "stage_b_s": stage_b_s,
            "stage_b_ms_per_step": stage_b_s * 1e3 / f, "launches": launches,
            "mesh_step_graph_replays": replays, "chunk_frames": chunk, "peak_mem_gib": peak,
            "detections_valid": own_dets, "all_hosts_detections_valid": int(metric_dets),
            "active_tracks": own, "all_hosts_active_tracks": int(metric)}


def parallel_rank(rank, world, tmp):
    """One rank of phase 18 (a spawned process per card, NCCL): (a) then
    (b); its report goes to tmp/rank<rank>.json. Any failure exits
    non-zero."""
    import torch

    sys.path.insert(0, ROOT)
    from tpupose_torch.parallel import make_mesh, multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    multihost.initialize("file://" + os.path.join(tmp, "rendezvous"), world, rank)
    try:  # a failure exits at once: a peer may be waiting in a collective
        model = 2 if world % 2 == 0 and world >= 4 else 1
        train = parallel_train(torch, make_mesh(data=world // model, model=model))
        streams = parallel_streams(torch, make_mesh(data=world, model=1))
        report = {"rank": rank, "cuda_device": torch.cuda.current_device(),
                  "backend": torch.distributed.get_backend(), "train": train,
                  "streams": streams}
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    torch.distributed.destroy_process_group()


def phase_parallel(torch, card):
    """Phase 18: one spawned process per visible card over NCCL, each
    running (a) and (b); any rank's failure or the timeout fails the run."""
    import multiprocessing
    import tempfile

    world = torch.cuda.device_count()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=parallel_rank, args=(r, world, tmp)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + PAR_TIMEOUT_S
        try:
            while any(p.exitcode is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    fail(f"phase 18: rank(s) {bad or 'all'} "
                         f"{'failed' if bad else f'ran past {PAR_TIMEOUT_S} s'}")
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
                p.join(30)
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            fail(f"phase 18: rank(s) {bad} exited with {[procs[r].exitcode for r in bad]}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    if {r["backend"] for r in ranks} != {"nccl"} or sorted(
            r["cuda_device"] for r in ranks) != list(range(world)):
        fail(f"phase 18: ranks on {[(r['backend'], r['cuda_device']) for r in ranks]}")
    losses = {tuple(r["train"]["losses"]) for r in ranks}
    if len(losses) != 1:
        fail(f"phase 18: the ranks' global losses differ: {losses}")
    for what in ("active_tracks", "detections_valid"):
        own = sum(r["streams"][what] for r in ranks)
        metrics = {r["streams"]["all_hosts_" + what] for r in ranks}
        if metrics != {own}:
            fail(f"phase 18: all_hosts_metric of {what} gave {metrics}, the ranks' own "
                 f"counts sum to {own}")
    frames = sum(r["streams"]["frames"] * (r["streams"]["streams"][1] - r["streams"]["streams"][0])
                 for r in ranks)
    return {"card": card, "world": world, "ranks": ranks,
            "streams_fps_all_cards": frames / max(r["streams"]["seconds"] for r in ranks),
            "streams_fps_sum_of_ranks": sum(r["streams"]["fps"] for r in ranks),
            "active_tracks": sum(r["streams"]["active_tracks"] for r in ranks),
            "detections_valid": sum(r["streams"]["detections_valid"] for r in ranks),
            "seconds": time.perf_counter() - t_phase}


def main():
    args = sys.argv[1:]
    seeds = only = None
    if args:
        if args[0] == "--learned-seeds" and len(args) > 1 and all(a.isdigit() for a in args[1:]):
            seeds = [int(a) for a in args[1:]]
        elif args[0] == "--only" and len(args) > 1 and set(args[1:]) <= {
                "k2", "k3", "ingest", "parallel", "graphs", "train", "epilogue", "vitpose",
                "hrformer"}:
            only = set(args[1:])
        else:
            fail("usage: chip_smoke.py [--learned-seeds SEED ... | "
                 "--only k2|k3|ingest|parallel|graphs|train|epilogue|vitpose|hrformer ...]",
                 2)
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
        if "ingest" in only:
            emit("ingest", **standalone_ingest(torch, card))
        if "parallel" in only:
            emit("parallel", **phase_parallel(torch, card))
        if "train" in only:
            emit("train", **phase_train(torch, card)[0])
        if "graphs" in only:
            emit("graphs", **phase_graphs(torch, card), captured=graphs_summary())
        if "train" in only:
            emit("train_profile", **phase_train_profile(torch, card))
        if "epilogue" in only:
            emit("epilogue", **phase_epilogue(torch, card))
        if "vitpose" in only:
            emit("vitpose", **phase_vitpose(th, torch, gen, card))
        if "hrformer" in only:
            emit("hrformer", **phase_hrformer(th, torch, gen, card))
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

    cli_path, bundles, ingest = phase_cli_path(torch, card)
    emit("cli_path", **cli_path)
    emit("bundle_pack", a=bundles["bf16"], b=bundles["int8"], c=pack,
         load_s_from_checkpoints=bundles["load_s_from_checkpoints"])
    emit("ingest", **ingest)
    cli_launches = {mode: cli_path[mode]["launches"] for mode in ("bf16", "int8")}

    emit("cli_tracks", **phase_cli_tracks(torch, card))

    train, w48, tiny = phase_train(torch, card)
    emit("train", **train)
    e2e = phase_e2e(torch, card, w48, tiny)
    emit("e2e", **e2e)
    del w48, tiny

    parallel = phase_parallel(torch, card)
    emit("parallel", **parallel)
    par_launches = [r["streams"]["launches"] for r in parallel["ranks"]]
    emit("graphs", **phase_graphs(torch, card))
    captured = graphs_summary()
    emit("graphs_captured", card=card, graphs=captured)
    # after every phase that times the host's launches: the profiler slows
    # every later one
    emit("train_profile", **phase_train_profile(torch, card))
    epi = phase_epilogue(torch, card)
    emit("epilogue", **epi)
    vitpose = phase_vitpose(th, torch, gen, card)
    emit("vitpose", **vitpose)
    hrformer = phase_hrformer(th, torch, gen, card)
    emit("hrformer", **hrformer)

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
        "ingest_launches": ingest["d"]["disk"]["launches"]["heatmap.launches"],
        "e2e_launches": e2e["k1_launches"],
        "multistream_launches": {m: c["k1"] for m, c in ms_launches.items()},
        "parallel_launches_per_rank": [c["k1"] for c in par_launches],
        "vitpose_launches": vitpose["launches"]["heatmap.launches"],
        "vitpose_max_abs_err": vitpose["k1"]["max_abs_err"],
        "hrformer_launches": hrformer["launches"]["heatmap.launches"],
    }, {
        "name": "int8_conv", "route": "cuda",
        "source": "tpupose_torch/csrc/int8_conv.cu",
        "replaces": "tpupose/models/quantize.py:210",
        "launches": int8["k2_launches"],
        "max_abs_err": k2["max_abs_err"], "ms": conv["ms"],
        "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
        "bound_by": conv["bound_by"], "library_ms": None, "layout": "channels-last",
        "nhwc_launches": int8["nhwc_launches"], "k2b_ms": conv["k2b"]["ms"],
        "int8_input_ms": conv["int8_input"]["ms"],
        "design_bound_ms": conv["design_bound_ms"],
        "bf16_cudnn_ms": conv["bf16_cudnn_ms"], "shape": conv["shape"],
        "yolo_3x3_128_256": k2["timed"]["yolo_3x3_128_256"],
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
        "halo": {
            "launches": int8["halo_launches"],
            "cli_launches": {m: c["int8_conv.halo_launches"] for m, c in cli_launches.items()},
            "multistream_launches": {m: c["k2b_halo"] for m, c in ms_launches.items()},
            "checked_launches": k2["k2b_launches_on_halo_path"],
            "edges_checked": k2["halo_edges"]["checked"],
            "rows": {name: halo_row(k2["timed"][name]) for name in (
                "hrnet_branch0_3x3_48", "hrnet_branch1_3x3_96", "yolo_3x3_128_256")}},
    }, {
        "name": "int8_stem", "route": "cuda",
        "source": "tpupose_torch/csrc/int8_conv.cu",
        "replaces": "tpupose/models/quantize.py:210",
        "launches": int8["stem_launches"],
        "max_abs_err": k2["stem_max_abs_err"], "ms": stem["ms"],
        "plain_ms": stem["plain_ms"], "bound_ms": stem["bound_ms"],
        "bound_by": stem["bound_by"], "library_ms": None, "layout": "channels-last",
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
        "layout": "channels-last input: the elementwise mode",
        "channels_last_launches": int8["quantize_cl_launches"],
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
        "ingest_launches": ingest["d"]["disk"]["k3_launches"],
        "multistream_launches": {m: c["k3"] for m, c in ms_launches.items()},
        "parallel_launches_per_rank": [c["k3"] for c in par_launches],
        "in_graphs": {  # K3 replayed inside the tracker's CUDA graphs, this process
            "per_replay": sorted({g["held_launches"]["lap.launches"] for g in captured}),
            "replays": sum(g["replays"] for g in captured),
            "launches": sum(g["replays"] * g["held_launches"]["lap.launches"]
                            for g in captured),
            "graphs": len(captured)},
    }, {
        "name": "bias_act_nhwc", "route": "cuda",
        "source": "tpupose_torch/csrc/epilogue.cu",
        "replaces": None,  # XLA fused the convs' epilogues on the TPU
        "launches": main_path["epilogue_launches"], "max_abs_err": epi["max_abs_err"],
        **{f: epi["shapes"]["hrnet_branch0_skip_relu"][f]
           for f in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "library_ms": None, "shapes": epi["shapes"], "cudnn_fused": epi["cudnn_fused"],
        "int8_clip_launches": int8["epilogue_launches"],
        "packed_launches": {m: pack[m]["launches"]["epilogue"] for m in ("bf16", "int8")},
        "cli_launches": {m: c["epilogue.launches"] for m, c in cli_launches.items()},
        "bundle_launches": bundles["int8"]["loop"]["launches"]["epilogue.launches"],
        "multistream_launches": {m: c["epilogue"] for m, c in ms_launches.items()},
        "vitpose_launches": vitpose["launches"]["epilogue.launches"],
        "vitpose_head": vitpose["head_epilogue"],
        "hrformer_launches": hrformer["launches"]["epilogue.launches"],
        "hrformer_ffn": hrformer["ffn_epilogue"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
