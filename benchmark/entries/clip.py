"""Entry "clip": `Pipeline.process_clip` in a closed loop, one client that
hands over the next clip when the last one is done, as the evaluation CLI
and a studio's recorder do.

The calls take the traffic's pool of clips in turn; the tracker's state
carries on from clip to clip, from a fresh state at the window's start.
The check, after the window:
  - a sample of images (`images_per_call` drawn from the seed in each of
    the last `pool` calls, whose detector heads a forward hook kept) held
    against the reference's stage A (`reference/judge.py`);
  - every call's keypoints and mask equal to those of the call that
    repeated its pool clip last (`stage_a_repeat_mismatch`, calls that
    differ), so each answer of the window is tied to a judged one;
  - every frame's tracker outputs against the reference tracker run over
    the program's own detections from the window's start.
The cell's control (`--control`) serves the bf16 configuration in int8
(the program's own lower-precision path) and, for the int8 configuration,
puts the reference in int4 in the program's place.
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
        import tpupose_torch.pipeline.facade as facade
        from tpupose_torch.pipeline import Pipeline

        self.ctx, self.facade = ctx, facade
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        self.precision = "int8" if ctx.control and cfg["precision"] == "bf16" else cfg["precision"]
        program.build_kernels(ctx, ["heatmap_decode", "lap"]
                              + (["int8_conv"] if self.precision == "int8" else []))
        self.rig = cfg["rig"]
        self.capacities = dict(cfg["capacities"], **ctx.spec.get("capacities", {}))
        self.tcfg = program.tracker_config(cfg, self.rig["views"], self.capacities)
        self.pool = generate.clip_pool(traffic, self.rig, subseed(ctx.seed, "frames"), dev)
        self.frames = traffic["frames"]
        self.frames_per_call = self.frames
        det_cfg, det, pose_cfg, pose = program.models(ctx)
        self.pipe = Pipeline(program.rig_camera_set(self.rig, dev), self.tcfg, det_cfg, det,
                             pose_cfg, pose, device=dev)
        if self.precision == "int8":
            self.pipe.quantize_models(self.calibration_frames(), **cfg["int8"]["quantize"])
        for i in range(ctx.spec.get("warmup_calls", 2)):
            self._run(i)
        self.pipe.track_restart()
        n = self.frames * self.rig["views"]
        rng = np.random.default_rng(subseed(ctx.seed, "sample"))
        m = ctx.spec["images_per_call"]
        self.plan = torch.as_tensor(np.stack([rng.choice(n, m, replace=False)
                                              for _ in range(PLAN_CALLS)]), device=dev)
        self.kept = collections.deque(maxlen=traffic["pool"])
        self.detector_calls = 0
        self.hook = self.pipe.detector.register_forward_hook(self._keep_heads)
        self.records = []
        self.restore = []
        self.counters0 = program.counters()

    def calibration_frames(self):
        c = self.ctx.config["int8"]["calibration"]
        return self.pool[c["clip"], :c["frames"], c["view"]].contiguous()

    def _keep_heads(self, module, inputs, heads):
        i = self.detector_calls
        self.detector_calls += 1
        idx = self.plan[i % PLAN_CALLS]
        # modulo the batch: a stage A that dropped images is judged on the
        # heads it has, against the images it was given
        self.kept.append((i, idx, [h[idx % len(h)].clone() for h in heads]))

    def _run(self, i):
        fids = torch.arange(i * self.frames, (i + 1) * self.frames, dtype=torch.int32,
                            device=self.ctx.device)
        return self.pipe.process_clip(fids, self.pool[i % len(self.pool)])

    def call(self, i):
        outs, dets, mask = self._run(i)
        self.records.append((dets, mask, outs.valid, outs.track_id, outs.pose3d))

    def instrument(self, spans):
        pipe, facade = self.pipe, self.facade
        pipe.process_clip_nn = spans.wrap("stage_a", pipe.process_clip_nn,
                                          lambda a, k: a[0].shape[0])
        original = facade.track_clip
        facade.track_clip = spans.wrap("stage_b", original, lambda a, k: a[3].shape[0])
        self.restore.append(lambda: setattr(facade, "track_clip", original))

    def counters(self):
        return program.counters(since=self.counters0)

    def work(self):
        return ops.frame_work(dict(self.ctx.config, precision=self.precision))

    def check(self):
        for undo in self.restore:
            undo()
        self.hook.remove()
        ctx, cfg = self.ctx, self.ctx.config
        recs = [[t.cpu() for t in r] for r in self.records]
        kept = list(self.kept)
        del self.pipe, self.records, self.kept
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = {"stage_a_repeat_mismatch": self._repeats(recs)}

        h, w = self.rig["height"], self.rig["width"]
        k = cfg["detector"]["max_candidates"]
        pool = self.pool.reshape(len(self.pool), -1, h, w, 3)
        images = torch.cat([pool[c % len(self.pool)][idx] for c, idx, _ in kept])
        heads = [torch.cat(hs) for hs in zip(*(hh for _, _, hh in kept))]
        kps = torch.cat([recs[c][0].reshape(-1, *recs[c][0].shape[2:])[idx.cpu(), :k]
                         for c, idx, _ in kept]).to(ctx.device)
        mask = torch.cat([recs[c][1].reshape(-1, recs[c][1].shape[-1])[idx.cpu(), :k]
                          for c, idx, _ in kept]).to(ctx.device)
        numbers.update(program.judge_stage_a(ctx, images, heads, kps, mask,
                                             self.calibration_frames()))
        del heads, images, pool
        self.pool = None
        prog = judge.program_frames(*(torch.cat([r[i] for r in recs]).numpy()
                                      for i in (2, 3, 4)))
        numbers.update(program.judge_tracker(ctx, self.rig, self.capacities, [(
            prog, torch.cat([r[0] for r in recs]).numpy(),
            torch.cat([r[1] for r in recs]).numpy())]))
        return numbers

    def _repeats(self, recs):
        """Calls whose keypoints or mask differ from the last call on the
        same pool clip."""
        p = len(self.pool)
        last = {i % p: r for i, r in enumerate(recs)}
        return sum(not (torch.equal(r[0], last[i % p][0]) and torch.equal(r[1], last[i % p][1]))
                   for i, r in enumerate(recs))
