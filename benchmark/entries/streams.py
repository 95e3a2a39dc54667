"""Entry "streams": several studios on one card,
`parallel.throughput.make_multistream_clip_fn` in a closed loop: each call
takes one clip of every stream (stream s reads pool clip s), runs stage A
over chunks of all streams' frames (`_auto_chunk`) and advances the
streams' trackers together, one replay of the captured vmapped step a
frame. A frame is one synchronised set of every stream's views.

The check, after the window: a sample of images (`images_per_call` drawn
from the seed in each detector call of the last call, whose heads a
forward hook kept, and whose keypoints the benchmark's wrapper of the
clip function's stage-A call kept) against the reference's stage A; every
chunk's keypoints and mask equal to the last call's (every call reads the
same clips); and each stream's tracker outputs against the reference
tracker over that stream's detections. The control is the clip entry's.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from benchmark import program
from benchmark.count import ops
from benchmark.harness import subseed
from benchmark.reference import judge
from benchmark.traffic import generate

PLAN_CALLS = 1 << 12  # more than any window completes


def setup(ctx):
    return Run(ctx)


class Run:
    def __init__(self, ctx):
        import tpupose_torch.parallel.throughput as throughput
        from tpupose_torch.parallel.streams import broadcast_cameras, init_multistream_state
        from tpupose_torch.pipeline import Pipeline

        self.ctx, self.throughput = ctx, throughput
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        self.precision = "int8" if ctx.control and cfg["precision"] == "bf16" else cfg["precision"]
        program.build_kernels(ctx, ["heatmap_decode", "lap"]
                              + (["int8_conv"] if self.precision == "int8" else []))
        self.rig = cfg["rig"]
        self.capacities = dict(cfg["capacities"], **ctx.spec.get("capacities", {}))
        self.tcfg = program.tracker_config(cfg, self.rig["views"], self.capacities)
        self.streams, self.frames = traffic["streams"], traffic["frames"]
        self.frames_per_call = self.frames
        self.pool = generate.clip_pool(dict(traffic, pool=self.streams), self.rig,
                                       subseed(ctx.seed, "frames"), dev)
        det_cfg, det, pose_cfg, pose = program.models(ctx)
        cams = program.rig_camera_set(self.rig, dev)
        pipe = Pipeline(cams, self.tcfg, det_cfg, det, pose_cfg, pose, device=dev)
        if self.precision == "int8":
            pipe.quantize_models(self.calibration_frames(), **cfg["int8"]["quantize"])
        self.detector, self.pose = pipe.detector, pipe.pose_model
        del pipe
        self.fn = throughput.make_multistream_clip_fn(det_cfg, pose_cfg, self.tcfg)
        self.cams = broadcast_cameras(cams, self.streams)
        self.init = lambda: init_multistream_state(self.tcfg, self.streams, dev)
        self.states = self.init()
        self.stage_a = None
        for i in range(ctx.spec.get("warmup_calls", 2)):
            self._run(i)
        self.states = self.init()
        cf = throughput._auto_chunk(self.streams, self.frames, self.rig["views"])
        self.chunk_frames = cf if self.frames % cf == 0 else self.frames
        n = self.streams * self.chunk_frames * self.rig["views"]
        rng = np.random.default_rng(subseed(ctx.seed, "sample"))
        m = ctx.spec["images_per_call"]
        self.plan = torch.as_tensor(np.stack([rng.choice(n, m, replace=False)
                                              for _ in range(PLAN_CALLS)]), device=dev)
        chunks = self.frames // self.chunk_frames
        self.kept = collections.deque(maxlen=chunks)
        self.stage_a = collections.deque(maxlen=chunks)
        self.detector_calls = 0
        self.hook = self.detector.register_forward_hook(self._keep_heads)
        self.inner = throughput._clip_detections
        throughput._clip_detections = self._keep_stage_a
        self.records = []
        self.counters0 = program.counters()

    def calibration_frames(self):
        c = self.ctx.config["int8"]["calibration"]
        return self.pool[c["clip"], :c["frames"], c["view"]].contiguous()

    def _keep_heads(self, module, inputs, heads):
        i = self.detector_calls
        self.detector_calls += 1
        idx = self.plan[i % PLAN_CALLS]
        self.kept.append((i, idx, [h[idx % len(h)].clone() for h in heads]))

    def _keep_stage_a(self, *args, **kwargs):
        dets, mask = self.inner(*args, **kwargs)
        self.stage_a.append((dets, mask))
        return dets, mask

    def _run(self, i):
        fids = torch.arange(i * self.frames, (i + 1) * self.frames, dtype=torch.int32,
                            device=self.ctx.device).expand(self.streams, -1)
        self.states, outs = self.fn(self.detector, self.pose, self.cams, self.states,
                                    self.pool, fids)
        return outs

    def call(self, i):
        outs = self._run(i)
        chunks = list(self.stage_a)[-(self.frames // self.chunk_frames):]
        self.records.append((outs.valid, outs.track_id, outs.pose3d, chunks))

    def instrument(self, spans):
        th = self.throughput
        self.inner = spans.wrap("stage_a", self.inner, lambda a, k: a[5].shape[0]
                                // (self.streams * self.rig["views"]))
        original, wrapped = th.captured_multistream_step, []

        def stage_b(*args):
            step = original(*args)
            if "clip" not in vars(step):  # the process's one step object, wrapped once
                step.clip = spans.wrap("stage_b", step.clip, lambda a, k: a[3].shape[0])
                wrapped.append(step)
            return step

        def undo():
            th.captured_multistream_step = original
            for step in wrapped:
                del step.clip

        th.captured_multistream_step = stage_b
        self.undo_b = undo

    def counters(self):
        return program.counters(since=self.counters0)

    def work(self):
        return [dict(i, ops=i["ops"] * self.streams, bytes=i["bytes"] * self.streams)
                for i in ops.frame_work(dict(self.ctx.config, precision=self.precision))]

    def check(self):
        self.throughput._clip_detections = self.inner
        getattr(self, "undo_b", lambda: None)()
        self.hook.remove()
        ctx, S, C = self.ctx, self.streams, self.rig["views"]
        cf = self.chunk_frames
        recs = [(v.cpu(), t.cpu(), p.cpu(), [(d.cpu(), m.cpu()) for d, m in ch])
                for v, t, p, ch in self.records]
        kept = list(self.kept)
        del self.records, self.kept, self.stage_a, self.detector, self.pose, self.fn
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        last = recs[-1][3]
        numbers = {"stage_a_repeat_mismatch": sum(
            not all(torch.equal(a, b) for (da, ma), (db, mb) in zip(r[3], last)
                    for a, b in ((da, db), (ma, mb))) for r in recs)}
        k = ctx.config["detector"]["max_candidates"]
        images, kps, mask = [], [], []
        for c, (i, idx, _) in enumerate(kept):
            # a chunk's images are (stream, frame of the chunk, view)
            s, rest = idx // (cf * C), idx % (cf * C)
            f, v = c * cf + rest // C, rest % C
            images.append(self.pool[s, f, v])
            d, m = last[c]
            kps.append(d[idx.cpu(), :k])
            mask.append(m[idx.cpu(), :k])
        heads = [torch.cat(hs) for hs in zip(*(hh for _, _, hh in kept))]
        numbers.update(program.judge_stage_a(
            ctx, torch.cat(images), heads, torch.cat(kps).to(ctx.device),
            torch.cat(mask).to(ctx.device), self.calibration_frames()))
        self.pool = None
        seqs = []
        for s in range(S):
            prog = judge.program_frames(*(torch.cat([r[j][s] for r in recs]).numpy()
                                          for j in range(3)))
            dets = torch.cat([d.reshape(S, cf, C, *d.shape[1:])[s] for r in recs
                              for d, _ in r[3]]).numpy()
            dmask = torch.cat([m.reshape(S, cf, C, *m.shape[1:])[s] for r in recs
                               for _, m in r[3]]).numpy()
            seqs.append((prog, dets, dmask))
        numbers.update(program.judge_tracker(ctx, self.rig, self.capacities, seqs))
        return numbers
