"""The HRFormer cell's files on the CPU: its operation count against a hand
count, and the harness driven end to end through the "clip_hrformer" entry
at a tiny size: a sound run is correct, and four planted faults of the
program's HRFormer (no relative position bias, the padding at the map's
corner, a nearest upsample in the fuse, GELU before BN in the FFN) are not,
by at least half the limit again, the program served with the weights the
reference draws (a sound run reads 2.6e-4 against the limit 2e-3, the faults
4.0e-3 to 2.8e-2)."""
from __future__ import annotations

import json

import pytest
import torch
import torch.nn.functional as F
from bench_fixtures import TINY_DETECTOR, bench_file

from benchmark import harness
from benchmark.count import hrformer as count

#: Small crops and one module a stage, but HRFormer-B's branch-0 block (78
#: wide, 2 heads of 39, 7x7 windows) on every branch: narrower branches
#: weaken the attention's share of the stream until a missing bias reads
#: like rounding at this size.
TINY_HRFORMER = dict(input_size=[128, 64], stem_channels=16, layer1_blocks=1, layer1_planes=8,
                     branch_channels=[78, 78, 78, 78], num_heads=[2, 2, 2, 2],
                     stage_modules=[1, 1, 1], stage_blocks=2, window_size=7)


def test_one_block_is_its_hand_count():
    """A branch-0 block of HRFormer-B on one crop: 96x72 of 78 channels, 2
    heads of 39, 14 x 11 windows of 49 tokens (7546 padded tokens)."""
    items = {i["name"].split(".", 1)[1]: i for i in count.block_items("b", 1, 78, 2, (96, 72),
                                                                        7, 4)}
    s, p = 154 * 49, 96 * 72
    assert items["attn.qkv"]["ops"] == 2 * s * 78 * 234
    assert items["attn"]["ops"] == 4 * 154 * 2 * 49 * 49 * 39
    assert items["attn"]["bytes"] == 4 * 2 * s * 78
    assert items["attn.proj"]["ops"] == 2 * s * 78 * 78
    assert items["ffn.fc1"]["ops"] == items["ffn.fc2"]["ops"] == 2 * p * 78 * 312
    assert items["ffn.dw3x3"]["ops"] == 2 * p * 312 * 9
    assert items["ffn.dw3x3"]["bytes"] == 2 * (2 * p * 312 + 312 * 9)
    assert {i["kind"] for i in items.values()} == {"matmul", "attention", "conv"}


def test_an_hrformer_b_crop_is_60_91_gflop():
    cfg = bench_file("configs", "shelf-yolov3-hrformer-b-bf16")
    items = count.hrformer_items(cfg["pose"], 1)
    assert abs(sum(i["ops"] for i in items) / 60.906e9 - 1) < 1e-3
    assert sum(i["kind"] == "attention" for i in items) == 44
    frame = count.frame_work(cfg)
    crops = sum(i["ops"] for i in frame if i["net"] == "hrformer") / 60.906e9
    assert abs(crops - 20) < 0.02  # 5 views x 4 candidates


@pytest.fixture
def hrf_root(tiny_root):
    root, bench = tiny_root
    cfg = bench_file("configs", "shelf-yolov3-hrformer-b-bf16")
    cfg["detector"].update(TINY_DETECTOR)
    cfg["pose"].update(TINY_HRFORMER)
    cfg["rig"].update(height=96, width=128)
    (root / "configs" / "tiny-hrf.json").write_text(json.dumps(cfg))
    spec = dict(bench_file("workloads", "hrformer-b-clip32"), warmup_calls=1, traced_calls=1,
                images_per_call=4)
    (root / "workloads" / "tiny-hrf-clip.json").write_text(json.dumps(spec))
    bench["configs"].append({"name": "tiny-hrf", "source": "test", "file": "tiny-hrf.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-hrf-clip", "config": "tiny-hrf",
                               "traffic": "tiny-clips", "chips": 1, "why": "test"})
    return root, bench


def run(hrf_root, trace=0):
    root, bench = hrf_root
    return harness.run_cell(bench, "tiny-hrf-clip", 2**31 + 91, 0.2, trace, "cpu",
                            (root, harness.HERE))


def test_a_sound_run_is_correct(hrf_root):
    from tpupose_torch.runtime import graphs

    graphs._STEPS.clear()
    result, numbers, extra = run(hrf_root, trace=1)
    assert result["correct"], result["checks"]
    assert numbers["stage_a_images"] == 2 * 4 and numbers["det_mask_mismatch"] == 0
    assert numbers["kp_belief_max"] < 0.5
    assert extra["attn_launches"] == 0  # the CPU takes the plain attention
    assert extra["epilogue_launches"] == 0  # and the composed epilogue
    assert "stage_b.ms_per_frame" in result["metrics"]


def _corner_index(h, w, window, device):
    import tpupose_torch.models.hrformer as hf

    hp, wp = h + -h % window, w + -w % window
    nh, nw = hp // window, wp // window
    rows = torch.arange(hp).view(nh, 1, window, 1).expand(nh, nw, window, window).reshape(-1)
    cols = torch.arange(wp).view(1, nw, 1, window).expand(nh, nw, window, window).reshape(-1)
    inside = (rows < h) & (cols < w)
    src = torch.where(inside, rows * w + cols, 0)
    dst = torch.empty(h * w, dtype=torch.int64)
    dst[src[inside]] = inside.nonzero().view(-1)
    return hf._WindowIndex(src, (~inside).nonzero().view(-1), dst)


def _gelu_before_bn(self, x, skip):
    for conv in (self.fc1, self.dw3x3, self.fc2):  # BN folded: its shift after the GELU
        y = conv(x, add_bias=False)
        x = F.gelu(y) + conv.bias.to(y.dtype)[:, None, None]
    return skip + x


def _fault(name, m):
    import tpupose_torch.models.hrformer as hf
    from tpupose_torch.ops import attention as tattn

    if name == "no_bias":
        m.setattr(hf, "attention", lambda q, k, v, scale, bias: tattn.attention(q, k, v, scale))
    elif name == "corner_padding":
        m.setattr(hf, "window_index", _corner_index)
    elif name == "nearest_upsample":
        interpolate = F.interpolate
        m.setattr(hf.F, "interpolate", lambda x, scale_factor, mode="nearest",
                  align_corners=None: interpolate(x, scale_factor=scale_factor, mode="nearest"))
    else:
        m.setattr(hf.CrossFFN, "forward", _gelu_before_bn)


@pytest.mark.parametrize("fault", ["no_bias", "corner_padding", "nearest_upsample",
                                   "gelu_before_bn"])
def test_planted_faults_are_not_correct(hrf_root, monkeypatch, fault):
    with monkeypatch.context() as m:
        _fault(fault, m)
        result, numbers, _ = run(hrf_root)
    limit = result["checks"]["kp_argmax_gap_mean"]["limit"]
    assert not result["correct"] and numbers["kp_argmax_gap_mean"] > 1.5 * limit, (
        fault, numbers["kp_argmax_gap_mean"])
