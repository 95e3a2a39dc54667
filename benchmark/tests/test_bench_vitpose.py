"""The ViTPose cell's files on the CPU: its operation count, and the
harness driven end to end through the "clip_vitpose" entry at a tiny size
(a sound run is correct; a run whose backbone hands its tokens to the
head out of order is not), the program's ViTPose served with the weights the
reference draws."""
from __future__ import annotations

import json

import pytest
from bench_fixtures import ROOT, TINY_DETECTOR, bench_file

from benchmark import harness
from benchmark.count import vit

TINY_VIT = dict(embed_dim=32, depth=2, num_heads=4, input_size=[64, 48])


def test_a_vitpose_h_crop_is_251_66_gflop():
    pose = bench_file("configs", "shelf-yolov3-vitpose-h-bf16")["pose"]
    items = vit.vit_items(pose, 1)
    assert abs(sum(i["ops"] for i in items) / 251.66e9 - 1) < 1e-3
    assert {i["kind"] for i in items} == {"matmul", "attention", "conv"}
    assert sum(i["kind"] == "attention" for i in items) == pose["depth"]
    assert [i["name"] for i in items if i["kind"] == "conv"] == [
        "patch_embed", "deconv_layers.0", "deconv_layers.3", "final_layer"]
    frame = vit.frame_work(bench_file("configs", "shelf-yolov3-vitpose-h-bf16"))
    crops = sum(i["ops"] for i in frame if i["net"] == "vitpose") / 251.66e9
    assert abs(crops - 20) < 0.02  # 5 views x 4 candidates


@pytest.fixture
def vit_root(tiny_root):
    root, bench = tiny_root
    cfg = bench_file("configs", "shelf-yolov3-vitpose-h-bf16")
    cfg["detector"].update(TINY_DETECTOR)
    cfg["pose"].update(TINY_VIT)
    cfg["rig"].update(height=96, width=128)
    (root / "configs" / "tiny-vit.json").write_text(json.dumps(cfg))
    spec = dict(bench_file("workloads", "vitpose-h-clip32"), warmup_calls=1, traced_calls=1,
                images_per_call=2)
    (root / "workloads" / "tiny-vit-clip.json").write_text(json.dumps(spec))
    bench["configs"].append({"name": "tiny-vit", "source": "test", "file": "tiny-vit.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-vit-clip", "config": "tiny-vit",
                               "traffic": "tiny-clips", "chips": 1, "why": "test"})
    return root, bench


def run(vit_root, trace=0):
    root, bench = vit_root
    return harness.run_cell(bench, "tiny-vit-clip", 2**31 + 77, 0.2, trace, "cpu",
                            (root, harness.HERE))


def test_a_sound_run_is_correct(vit_root):
    from tpupose_torch.runtime import graphs

    graphs._STEPS.clear()
    result, numbers, extra = run(vit_root, trace=1)
    assert result["correct"], result["checks"]
    assert numbers["stage_a_images"] == 2 * 2 and numbers["det_mask_mismatch"] == 0
    assert extra["attn_launches"] == 0  # the CPU takes the plain attention
    assert extra["epilogue_launches"] == 0  # and the composed epilogue
    assert "stage_b.ms_per_frame" in result["metrics"]


def test_tokens_out_of_order_are_not_correct(vit_root, monkeypatch):
    """The backbone's tokens handed to the head in reverse order (the grid
    turned half a turn, a layout fault)."""
    import tpupose_torch.models.vitpose as tv

    forward = tv.ViT.forward
    monkeypatch.setattr(tv.ViT, "forward", lambda self, x: forward(self, x).flip(2, 3))
    result, numbers, _ = run(vit_root)
    limit = result["checks"]["kp_argmax_gap_mean"]["limit"]
    assert not result["correct"] and numbers["kp_argmax_gap_mean"] > 10 * limit
