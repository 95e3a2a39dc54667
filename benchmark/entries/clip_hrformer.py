"""Entry "clip_hrformer": the "clip" entry's closed loop of
`Pipeline.process_clip` with HRFormer as the pose net.

The loop, the spans (`instrument`), the repeat check and the tracker's
check are the clip entry's (`entries/clip.py`, loaded by name); this entry
builds the two networks itself, YOLOv3 and HRFormer from the weights that
`reference/hrformer.py` draws from the run's seed, folds their BN and
serves them in bf16, and judges stage A against `reference/hrformer.py`.
Its work is `count/hrformer.py`'s. It reports the fused attention's calls
(`tpupose_torch.ops.attention.launches`, 44 a forward) as `attn_launches`
and the conv epilogue's (`tpupose_torch.ops.epilogue.launches`) as
`epilogue_launches`.

The cell's control (`--control`) puts the reference's fp8 HRFormer (every
linear's input and weight rounded to float8 e4m3: qkv, proj and the FFN's
1x1 convs) in the program's place in the judged sample; the program serves
bf16 either way.

A program without HRFormer fails at once, in `setup`.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import program
from benchmark.count import hrformer as count
from benchmark.harness import load_module, subseed
from benchmark.reference import hrformer as hfref
from benchmark.reference import judge

_clip = load_module("entries", "clip")


def setup(ctx):
    import tpupose_torch.models.hrformer  # noqa: F401  (a program without it stops here)

    return Run(ctx)


def pose_config(pose):
    from tpupose_torch.models.hrformer import HRFormerConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in pose.items() if k != "arch"}
    return HRFormerConfig(**kw)


def models(ctx):
    """The folded bf16 YOLOv3 and HRFormer, with the weights the reference
    draws from the run's seed."""
    from tpupose_torch.models.hrformer import HRFormer
    from tpupose_torch.models.layers import fold_batchnorm
    from tpupose_torch.models.yolov3 import YOLOv3, YoloConfig

    cfg = ctx.config
    det_cfg, pose_cfg = YoloConfig(**cfg["detector"]), pose_config(cfg["pose"])
    ysd, hsd = hfref.make_weights(cfg, subseed(ctx.seed, "weights"), ctx.device)
    with torch.device("meta"):
        det, pose = YOLOv3(det_cfg), HRFormer(pose_cfg)
    det.load_state_dict(ysd, strict=True, assign=True)
    pose.load_state_dict(hsd, strict=True, assign=True)
    del ysd, hsd
    return (det_cfg, fold_batchnorm(det, dtype=torch.bfloat16),
            pose_cfg, fold_batchnorm(pose, dtype=torch.bfloat16))


def judge_stage_a(ctx, images, heads, kps, mask, calib):
    """The stage-A numbers of the sampled images against the reference's
    float32 HRFormer; under the control, the fp8 reference's own outputs
    stand in the program's place. Also `kp_belief_max`, the largest belief
    (mean non-negative joint score, the tracker's) of a sampled valid
    detection: under the tracker's 0.5 gate, no track starts."""
    weight_seed = subseed(ctx.seed, "weights")
    ref = hfref.HRFormerReference(ctx.config, weight_seed, ctx.device)
    if ctx.fp8_control:
        heads, kps, mask = hfref.HRFormerReference(ctx.config, weight_seed, ctx.device,
                                                   fp8=True).outputs(images)
    scores = kps[..., 2].float()
    nonneg = scores >= 0
    belief = torch.where(nonneg, scores, 0).sum(-1) / nonneg.sum(-1).clamp(min=1)
    return dict(judge.stage_a_numbers(ref, images, heads, kps, mask),
                kp_belief_max=float(torch.where(mask, belief, 0).max()))


class _Program:
    """`benchmark.program` with this cell's networks and stage-A judge."""

    models = staticmethod(models)
    judge_stage_a = staticmethod(judge_stage_a)

    def __getattr__(self, name):
        return getattr(program, name)


_clip.program = _Program()


class Run(_clip.Run):
    def __init__(self, ctx):
        # the clip entry reads `control` as "serve int8": here the program
        # serves bf16 under the control too, and the judge reads fp8_control
        super().__init__(SimpleNamespace(**dict(vars(ctx), control=False,
                                                fp8_control=ctx.control)))
        from tpupose_torch.ops import attention, epilogue

        self.attention, self.epilogue = attention, epilogue
        self.attn0, self.epi0 = attention.launches, epilogue.launches

    def calibration_frames(self):
        return None

    def counters(self):
        return dict(super().counters(), attn_launches=self.attention.launches - self.attn0,
                    epilogue_launches=self.epilogue.launches - self.epi0)

    def work(self):
        return count.frame_work(self.ctx.config)
