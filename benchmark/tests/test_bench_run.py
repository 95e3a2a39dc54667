"""The harness driven end to end on the CPU at tiny sizes (its look for a
card skipped): sound runs come out correct, and runs with the timed path
broken underneath come out not correct. Also: `run.py` refuses to run
without a card, and nothing that a run loads is JAX or the JAX package."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from bench_fixtures import ROOT

from benchmark import harness


def run(tiny_root, cell, seed=2**31 + 101, seconds=0.2, trace=0):
    root, bench = tiny_root
    return harness.run_cell(bench, cell, seed, seconds, trace, "cpu", (root, harness.HERE))


@pytest.fixture
def fresh_graphs(monkeypatch):
    """An empty cache of captured tracker steps, so that a patched step is
    the one the run captures."""
    from tpupose_torch.runtime import graphs

    monkeypatch.setattr(graphs, "_STEPS", {})


@pytest.mark.parametrize("cell", ["tiny-bf16-clip", "tiny-int8-clip", "tiny-replay",
                                  "tiny-streams"])
def test_sound_runs_are_correct(tiny_root, fresh_graphs, cell):
    result, numbers, extra = run(tiny_root, cell, trace=1)
    assert result["correct"], result["checks"]
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert result["attempted"] == extra["calls"] >= 1
    assert "stage_b.ms_per_frame" in result["metrics"]


def test_a_step_that_returns_its_state_unchanged(tiny_root, fresh_graphs, monkeypatch):
    import tpupose_torch.tracking.tracker as tracker

    step = tracker.tracker_step

    def unchanged(cfg, cams, state, *args):
        return state, step(cfg, cams, state, *args)[1]

    monkeypatch.setattr(tracker, "tracker_step", unchanged)
    result, numbers, _ = run(tiny_root, "tiny-replay")
    assert not result["correct"] and numbers["track_unmatched_share"] > 0.5


def test_an_answer_altered_where_it_is_produced(tiny_root, fresh_graphs, monkeypatch):
    import tpupose_torch.pipeline.facade as facade

    decode = facade.decode_heatmaps_auto

    def shifted(heat, boxes, refine=True):
        kps = decode(heat, boxes, refine=refine)
        return kps + torch.stack([(boxes[:, 2] - boxes[:, 0]) / 4,
                                  torch.zeros_like(boxes[:, 0]),
                                  torch.zeros_like(boxes[:, 0])], -1)[:, None]

    monkeypatch.setattr(facade, "decode_heatmaps_auto", shifted)
    result, numbers, _ = run(tiny_root, "tiny-bf16-clip")
    limit = result["checks"]["kp_argmax_gap_mean"]["limit"]
    assert not result["correct"] and numbers["kp_argmax_gap_mean"] > 10 * limit


def test_a_pose_altered_where_it_is_produced(tiny_root, fresh_graphs, monkeypatch):
    import tpupose_torch.tracking.tracker as tracker

    step = tracker.tracker_step

    def moved(*args):
        state, out = step(*args)
        return state, out._replace(pose3d=out.pose3d + 0.05)

    monkeypatch.setattr(tracker, "tracker_step", moved)
    result, numbers, _ = run(tiny_root, "tiny-replay")
    assert not result["correct"] and numbers["track_pose_gap_m"] > 0.04
    assert numbers["track_off_share"] > result["checks"]["track_off_share"]["limit"]


def test_half_of_the_batch_left_out(tiny_root, fresh_graphs, monkeypatch):
    """Stage A computes the first half of its images; the rest get the mean
    of what was computed."""
    import tpupose_torch.pipeline.facade as facade

    whole = facade._clip_detections

    def half(det_cfg, pose_cfg, tcfg, det, pose, images, dtype=torch.bfloat16):
        n = images.shape[0] // 2
        dets, mask = whole(det_cfg, pose_cfg, tcfg, det, pose, images[:n], dtype)
        fill = dets.mean(0, keepdim=True).expand(images.shape[0] - n, *dets.shape[1:])
        return torch.cat([dets, fill]), torch.cat([mask, mask[:1].expand(len(fill), -1)])

    monkeypatch.setattr(facade, "_clip_detections", half)
    result, numbers, _ = run(tiny_root, "tiny-bf16-clip")
    limit = result["checks"]["kp_argmax_gap_mean"]["limit"]
    assert not result["correct"] and numbers["kp_argmax_gap_mean"] > 10 * limit


def _first_valid(valid):
    """The first valid slot of each frame's outputs, as a mask."""
    return valid & (torch.cumsum(valid.int(), -1) == 1)


ONE_SLOT_FAULTS = {
    "lost": lambda out, fid: out._replace(valid=out.valid & ~_first_valid(out.valid)),
    "moved": lambda out, fid: out._replace(
        pose3d=out.pose3d + 0.3 * _first_valid(out.valid)[:, None, None]),
    "replaced": lambda out, fid: out._replace(
        pose3d=out.pose3d + 5.0 * _first_valid(out.valid)[:, None, None]),
    "renamed": lambda out, fid: out._replace(track_id=torch.where(
        _first_valid(out.valid), out.track_id + 1000 * (1 + fid % 2), out.track_id)),
}


@pytest.mark.parametrize("fault", sorted(ONE_SLOT_FAULTS))
def test_one_slot_of_the_tracker_at_fault(tiny_root, fresh_graphs, monkeypatch, fault):
    """One output slot of every frame lost, moved by 0.3 m (inside the
    match gate), replaced by a pose beyond the gate, or given an id that
    changes from frame to frame; the other slots sound. The replay's
    compared numbers, at the real cell's limits, come out not correct."""
    import tpupose_torch.tracking.tracker as tracker

    step, plant = tracker.tracker_step, ONE_SLOT_FAULTS[fault]

    def faulty(cfg, cams, state, dets, mask, fid):
        state, out = step(cfg, cams, state, dets, mask, fid)
        return state, plant(out, fid)

    monkeypatch.setattr(tracker, "tracker_step", faulty)
    result, numbers, _ = run(tiny_root, "tiny-replay")
    assert not result["correct"], result["checks"]
    assert numbers["track_off_share"] > result["checks"]["track_off_share"]["limit"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bf16-clip32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_nothing_of_jax_loads(tiny_root):
    """A whole run in a fresh process loads no module whose top-level name
    is jax, jaxlib, flax or tpupose (`tpupose_torch` is not `tpupose`)."""
    root, bench = tiny_root
    (root / "bench.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "from pathlib import Path; from benchmark import harness;"
        "b = json.loads(Path(sys.argv[2], 'bench.json').read_text());"
        "r, n, e = harness.run_cell(b, 'tiny-bf16-clip', 5, 0.1, 0, 'cpu',"
        " (Path(sys.argv[2]), harness.HERE));"
        "assert 'tpupose_torch' in sys.modules;"
        "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(root)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpupose_torch_like", sys)
    assert "tpupose_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


@pytest.mark.card
@pytest.mark.parametrize("cell", ["bf16-clip32", "int8-clip32", "bf16-replay",
                                  "int8-streams4"])
def test_control_is_not_correct_on_the_card(card, cell):
    """The cell's control (its lower precision in the program's place) at
    the cell's own size on three seeds: `correct` comes out false."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        result, numbers, _ = harness.run_cell(bench, cell, seed, 2.0, 0, card, control=True)
        assert not result["correct"], (seed, result["checks"])
