"""Entry "replay": the tracker alone, `tracking.track_clip` in a closed
loop over clips of replayed 2D detections, as users re-score tracker
settings on cached detections. Stage A is bypassed.

The traffic's scene is cut into clips of `frames_per_clip` frames; a pass
over the scene starts from a fresh tracker state, and the calls run pass
after pass. The check runs the reference tracker once over the scene and
holds every frame of every pass in the window against it. The control
(`--control`) puts the reference tracker in the program's place with what
it reads rounded to bfloat16 (detections and camera matrices), the
nearest precision below the tracker's float32 for its elementwise
arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import program
from benchmark.harness import subseed
from benchmark.reference import judge, oracle
from benchmark.traffic import generate


def setup(ctx):
    return Run(ctx)


class Run:
    def __init__(self, ctx):
        import tpupose_torch.tracking.tracker as tracker
        from tpupose_torch.geometry import make_camera_set

        self.ctx, self.tracker = ctx, tracker
        program.build_kernels(ctx, ["lap"])
        traffic, dev = ctx.traffic, ctx.device
        self.capacities = dict(ctx.config["capacities"], **ctx.spec.get("capacities", {}))
        self.scene = generate.replay_scene(traffic, subseed(ctx.seed, "scene"))
        dets, mask = generate.padded_detections(self.scene, self.capacities["max_dets"])
        self.tcfg = program.tracker_config(ctx.config, traffic["views"], self.capacities)
        self.cams = make_camera_set(self.scene.P, self.scene.K, self.scene.RT,
                                    self.scene.width, self.scene.height, device=dev)
        self.frames_per_call = traffic["frames_per_clip"]
        self.clips = traffic["scene_frames"] // self.frames_per_call
        self.dets = torch.as_tensor(dets, device=dev)
        self.mask = torch.as_tensor(mask, device=dev)
        self.fids = torch.arange(traffic["scene_frames"], dtype=torch.int32, device=dev)
        self.track_clip = tracker.track_clip
        for i in range(ctx.spec.get("warmup_calls", 2)):
            self.call(i)
        self.records = []
        self.counters0 = program.counters()

    def call(self, i):
        k = i % self.clips
        if k == 0:
            self.state = self.tracker.init_state(self.tcfg, self.ctx.device)
        s = slice(k * self.frames_per_call, (k + 1) * self.frames_per_call)
        self.state, outs = self.track_clip(self.tcfg, self.cams, self.state, self.dets[s],
                                           self.mask[s], self.fids[s])
        if hasattr(self, "records"):
            self.records.append((i, outs.valid, outs.track_id, outs.pose3d))

    def instrument(self, spans):
        self.track_clip = spans.wrap("stage_b", self.track_clip, lambda a, k: a[3].shape[0])

    def counters(self):
        return program.counters(since=self.counters0)

    def work(self):
        return []

    def check(self):
        recs = [(i, *(t.cpu().numpy() for t in r)) for i, *r in self.records]
        del self.records, self.state
        f, sc = self.frames_per_call, self.scene
        need = min(len(recs), self.clips) * f
        dets, mask = generate.padded_detections(sc, self.capacities["max_dets"])
        params = program.oracle_params(self.ctx.config, self.capacities)
        ref = judge.reference_frames(oracle.OracleTracker(oracle.rig(sc.P, sc.K, sc.RT), params),
                                     dets[:need], mask[:need])
        if self.ctx.control:
            low = oracle.OracleTracker(oracle.rig(*(judge.to_bf16(a) for a in (sc.P, sc.K, sc.RT))),
                                       params)
            frames = judge.reference_frames(low, judge.to_bf16(dets[:need]), mask[:need])
            recs = [(i, *_stacked(frames[(i % self.clips) * f:][:f], self.capacities["max_tracks"]))
                    for i, *_ in recs]
        passes = {}
        for i, *outs in recs:
            passes.setdefault(i // self.clips, []).append(outs)
        seqs = [list(zip(judge.program_frames(*(np.concatenate(o) for o in zip(*clips))), ref))
                for clips in passes.values()]
        numbers = judge.tracker_numbers(seqs, self.ctx.spec.get("match_gate_m", 0.5),
                                        self.ctx.spec.get("off_m", 0.01))
        numbers["passes"] = len(passes)
        return numbers


def _stacked(frames, slots):
    """Per-frame {id: pose} -> stacked (valid, track_id, pose3d) arrays."""
    valid = np.zeros((len(frames), slots), bool)
    tid = np.full((len(frames), slots), -1, np.int64)
    pose = np.zeros((len(frames), slots, 17, 3))
    for f, fr in enumerate(frames):
        for s, (i, p) in enumerate(list(fr.items())[:slots]):
            valid[f, s], tid[f, s], pose[f, s] = True, i, p
    return valid, tid, pose
