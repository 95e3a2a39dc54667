"""Result writers — artifact formats identical to the reference.

Counterpart of `tpupose/eval/writers.py`. `write_3d_result` pickles the
per-frame 3D pose dict (`src/evalmodel.py:373-377`); `write_2d_result`
emits one JSON per camera (`src/evalmodel.py:352-371`). 2D poses are
stored (x, y, score), so no coordinate flip is needed at write time (the
reference stores (y, x) and flips on output: points_2d are (x, y) either
way).
"""
from __future__ import annotations

import json
import os
import pickle


def write_3d_result(multi_poses3d, filepath):
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    with open(filepath, "wb") as f:
        pickle.dump(multi_poses3d, f)


def write_2d_result(image_wh, annotations, save_dir="TrackResult"):
    """annotations: list of dicts {timestamp, cid, pid, pose (J,2) xy,
    scores (J,)}.

    `image_wh` is written as [image_wh[1], image_wh[0]], as the JAX
    package writes it: its callers pass (height, width), so the JSON holds
    [width, height]."""
    os.makedirs(save_dir, exist_ok=True)
    cameras = {}
    for ann in annotations:
        camera = "Camera" + str(ann["cid"])
        timestamp = ann["timestamp"]
        frame_name = f"{camera}{os.sep}{timestamp}.jpg"
        cameras.setdefault(
            camera, {"image_wh": [image_wh[1], image_wh[0]], "frames": {}}
        )
        frames = cameras[camera]["frames"]
        frames.setdefault(
            frame_name,
            {"camera": camera, "timestamp": float(timestamp), "poses": []},
        )
        frames[frame_name]["poses"].append(
            {
                "id": ann["pid"],
                "points_2d": [list(map(float, p)) for p in ann["pose"]],
                "scores": list(map(float, ann["scores"])),
            }
        )
    for key, value in cameras.items():
        with open(os.path.join(save_dir, key + ".json"), "w") as fp:
            json.dump(value, fp)
