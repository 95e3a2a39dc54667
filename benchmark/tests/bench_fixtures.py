"""Shared helpers of the benchmark's CPU tests: the checkout's root and
tiny configurations made from the real configuration files."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DETECTOR = dict(num_classes=2, input_size=64, width_mult=1 / 16)
TINY_POSE = dict(width=8, input_size=[96, 64], stem_channels=16, layer1_blocks=1,
                 layer1_planes=8, stage_modules=[1, 1, 1], stage_blocks=1)


def tiny_config(precision):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg_name = next(c["name"] for c in bench["configs"] if c["name"].endswith("-bf16"))
    c = json.loads((ROOT / "benchmark" / "configs" / f"{cfg_name}.json").read_text())
    c["detector"].update(TINY_DETECTOR)
    c["pose"].update(TINY_POSE)
    c["rig"].update(height=96, width=128)
    c["int8"]["calibration"]["frames"] = 2
    c["precision"] = precision
    return c


def bench_file(kind, name):
    return json.loads((ROOT / "benchmark" / kind / f"{name}.json").read_text())


def make_tiny_root(tmp_path):
    """(root, bench): tiny files under root and a BENCHMARK dict naming
    the cells tiny-bf16-clip, tiny-int8-clip, tiny-replay and tiny-streams."""
    for kind in ("configs", "traffic", "workloads", "metrics"):
        (tmp_path / kind).mkdir()

    def dump(kind, name, obj):
        (tmp_path / kind / f"{name}.json").write_text(json.dumps(obj))

    dump("configs", "tiny-bf16", tiny_config("bf16"))
    dump("configs", "tiny-int8", tiny_config("int8"))
    dump("traffic", "tiny-clips", {"kind": "clip_pool", "frames": 3, "pool": 2})
    dump("traffic", "tiny-replay", {"kind": "scene", "frames_per_clip": 4, "scene_frames": 8,
                                    "views": 5, "actors": 4, "noise_px": 1.5,
                                    "occlusion_px": 60.0, "fp_per_view": 1, "drop_prob": 0.1})
    clip = {"entry": "clip", "warmup_calls": 1, "traced_calls": 1, "images_per_call": 2}
    replay = {"entry": "replay", "warmup_calls": 1, "traced_calls": 1,
              "capacities": {"max_dets": 16, "max_tracks": 16, "max_hyp": 40}}
    dump("traffic", "tiny-streams", {"kind": "clip_pool", "frames": 4, "pool": 2, "streams": 2})
    # each tiny cell compares the numbers of its real cell, at their limits
    for name, spec, real in (("tiny-bf16-clip", clip, "bf16-clip32"),
                             ("tiny-int8-clip", clip, "int8-clip32"),
                             ("tiny-streams", dict(clip, entry="streams"), "int8-streams4"),
                             ("tiny-replay", replay, "bf16-replay")):
        judged = {k: v for k, v in bench_file("workloads", real).items()
                  if k in ("checks", "match_gate_m", "off_m")}
        dump("workloads", name, dict(spec, **judged))
    bench = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    bench["configs"] = [{"name": n, "source": "test", "file": f"{n}.json", "reduced": [],
                         "why": "test"} for n in ("tiny-bf16", "tiny-int8")]
    bench["workloads"] = [
        {"name": "tiny-bf16-clip", "config": "tiny-bf16", "traffic": "tiny-clips", "chips": 1,
         "why": "test"},
        {"name": "tiny-int8-clip", "config": "tiny-int8", "traffic": "tiny-clips", "chips": 1,
         "why": "test"},
        {"name": "tiny-replay", "config": "tiny-bf16", "traffic": "tiny-replay", "chips": 1,
         "why": "test"},
        {"name": "tiny-streams", "config": "tiny-int8", "traffic": "tiny-streams", "chips": 1,
         "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return tmp_path, bench
