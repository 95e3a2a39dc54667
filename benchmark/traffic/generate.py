"""The one generator of the benchmark's traffic: it reads a traffic file's
parameters (`benchmark/traffic/<name>.json`) and makes the inputs from the
run's seed. Kinds:

  "clip_pool"  a pool of `pool` distinct clips of `frames` frames of the
               rig's views, uint8 RGB drawn uniformly on the device; the
               calls take them in turn, so every call of a run sees the
               same sizes.
  "scene"      replayed 2D detections of `make_continuous_adversarial_scene`
               (`scene.py`), cut into clips of `frames_per_clip` frames.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import scene as scenes


def rig_cameras(rig):
    """(P, K, RT) of the rig: a ring of `views` cameras looking at the
    scene's centre, at the rig's image size."""
    ring = rig.get("ring", {})
    return scenes.camera_ring(num_cameras=rig["views"], w=rig["width"], h=rig["height"],
                              **ring)


def clip_pool(traffic, rig, seed, device):
    """(pool, F, C, H, W, 3) uint8 frames from `seed`, made on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (traffic["pool"], traffic["frames"], rig["views"], rig["height"], rig["width"], 3)
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)


def replay_scene(traffic, seed):
    """The scene of a "scene" traffic file from `seed`."""
    return scenes.make_continuous_adversarial_scene(
        num_frames=traffic["scene_frames"], num_cameras=traffic["views"],
        num_actors=traffic["actors"], noise_px=traffic["noise_px"], seed=seed,
        occlusion_px=traffic["occlusion_px"], fp_per_view=traffic["fp_per_view"],
        drop_prob=traffic["drop_prob"])


def padded_detections(scene, max_dets):
    """(T, C, D, J, 3) f32 detections and (T, C, D) mask: each view's
    visible detections first, in the scene's order."""
    t, c, m = scene.visible.shape
    dets = np.zeros((t, c, max_dets, scene.detections.shape[3], 3), np.float32)
    mask = np.zeros((t, c, max_dets), bool)
    for f in range(t):
        for v in range(c):
            d = scene.detections[f, v][scene.visible[f, v]][:max_dets]
            dets[f, v, :len(d)] = d
            mask[f, v, :len(d)] = True
    return dets, mask
