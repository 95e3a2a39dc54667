"""The reference agrees with the port at tiny sizes on the CPU, and its
frozen copies equal what they were copied from: the networks' keys and
shapes, their float forwards, the detector decode and selection, the
heatmap decode, the integer convs, the tracker oracle and the scene
generator. (A test may import both; the reference itself imports nothing
of the program.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from bench_fixtures import tiny_config

from benchmark.reference import judge, nets, oracle, quant, stage_a
from benchmark.reference.pipeline import Reference, make_weights
from benchmark.traffic import generate, scene


def port_models(cfg, device="cpu"):
    from tpupose_torch.models.hrnet import HRNet, HRNetConfig
    from tpupose_torch.models.yolov3 import YOLOv3, YoloConfig

    pose = dict(cfg["pose"], input_size=tuple(cfg["pose"]["input_size"]),
                stage_modules=tuple(cfg["pose"]["stage_modules"]))
    return YoloConfig(**cfg["detector"]), HRNetConfig(**pose), YOLOv3, HRNet


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "published"])
def test_state_dict_keys_and_shapes(tiny):
    cfg = tiny_config("bf16")
    if not tiny:
        cfg["detector"].update(num_classes=80, input_size=416, width_mult=1.0)
        cfg["pose"].update(width=48, input_size=[384, 288], stem_channels=64, layer1_blocks=4,
                           layer1_planes=64, stage_modules=[1, 4, 3], stage_blocks=4)
    det_cfg, pose_cfg, YOLOv3, HRNet = port_models(cfg)
    with torch.device("meta"):
        det, pose = YOLOv3(det_cfg), HRNet(pose_cfg)
    ours = {**nets.state_dict_shapes(nets.yolo_specs(det_cfg.num_classes, det_cfg.width_mult))}
    assert {k: tuple(v.shape) for k, v in det.state_dict().items()} == \
        {k: shp for k, (shp, _) in ours.items()}
    ours = nets.state_dict_shapes(nets.hrnet_specs(**nets.hrnet_kwargs(cfg["pose"])))
    assert {k: tuple(v.shape) for k, v in pose.state_dict().items()} == \
        {k: shp for k, (shp, _) in ours.items()}


def _loaded(cfg, seed=3):
    from tpupose_torch.models.layers import fold_batchnorm

    det_cfg, pose_cfg, YOLOv3, HRNet = port_models(cfg)
    ysd, hsd = make_weights(cfg, seed, "cpu")
    det, pose = YOLOv3(det_cfg), HRNet(pose_cfg)
    det.load_state_dict(ysd)
    pose.load_state_dict(hsd)
    return det_cfg, fold_batchnorm(det), pose_cfg, fold_batchnorm(pose)


@torch.no_grad()
def test_float_forwards_and_decodes_match_the_port():
    from tpupose_torch.models.yolov3 import decode_detections, detect_people, prepare_yolo_images
    from tpupose_torch.ops.heatmap import decode_heatmaps, expand_box_to_aspect
    from tpupose_torch.ops.image import crop_and_resize
    from tpupose_torch.models.hrnet import normalize_image

    cfg = tiny_config("bf16")
    det_cfg, det, pose_cfg, pose = _loaded(cfg)
    ref = Reference(cfg, 3, "cpu")
    gen = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (3, 96, 128, 3), generator=gen, dtype=torch.uint8)
    x = prepare_yolo_images(det_cfg, frames.float() / 255.0)
    heads = det(x.permute(0, 3, 1, 2), torch.float32)
    ref_heads = ref.yolo_heads(frames)
    for a, b in zip(heads, ref_heads):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    boxes, scores, valid = detect_people(det, det_cfg, x, (96, 128), torch.float32)
    rb, rs, rv = ref.detect(heads, (96, 128))
    torch.testing.assert_close(rb, boxes)
    torch.testing.assert_close(rs, scores)
    assert torch.equal(rv, valid)
    pb, ps = decode_detections(det_cfg, heads)
    qb, qs = stage_a.decode_heads(heads, det_cfg.input_size, det_cfg.num_classes)
    assert torch.equal(pb, qb) and torch.equal(ps, qs)

    eboxes = expand_box_to_aspect(boxes.reshape(-1, 4), 96 / 64)
    crops = crop_and_resize(frames.float() / 255.0, eboxes.reshape(3, -1, 4), (96, 64))
    crops = normalize_image(crops.reshape(-1, 96, 64, 3), value_scale=1.0).permute(0, 3, 1, 2)
    heat = pose(crops, torch.float32)
    ref_heat, ref_eboxes = ref.heatmaps(frames, boxes)
    torch.testing.assert_close(ref_eboxes, eboxes)
    torch.testing.assert_close(ref_heat, heat, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(stage_a.decode_heatmaps(heat, eboxes),
                               decode_heatmaps(heat, eboxes, refine=True))


@torch.no_grad()
def test_integer_convs_match_the_port():
    """int8 reference convs against the port's PTQ, both calibrated in
    float32 on the same batch: the same scales, the same codes but where a
    product lands on a rounding edge."""
    from tpupose_torch.models.quantize import quantize_convs, yolo_skip_ids
    from tpupose_torch.models.yolov3 import prepare_yolo_images
    from tpupose_torch.models.quantize import calibrate

    cfg = tiny_config("int8")
    det_cfg, det, _, _ = _loaded(cfg)
    gen = torch.Generator().manual_seed(1)
    frames = torch.randint(0, 256, (2, 96, 128, 3), generator=gen, dtype=torch.uint8)
    x = prepare_yolo_images(det_cfg, frames.float() / 255.0).permute(0, 3, 1, 2)
    scales = calibrate(lambda b: det(b, torch.float32), x)
    q = quantize_convs(det, scales, yolo_skip_ids(det, det_cfg))
    port = q(x, torch.float32)
    specs = nets.yolo_specs(det_cfg.num_classes, det_cfg.width_mult)
    sd = make_weights(cfg, 3, "cpu")[0]
    folded = nets.fold(specs, sd)
    names = {s.name for s in specs if s.bn is not None}
    absmax = quant.calibrate(nets.yolo_forward, nets.float_conv(specs, folded), x, names)
    ours = nets.yolo_forward(quant.quantized_conv(specs, folded, absmax, 8), x)
    for a, b in zip(port, ours):
        assert float((a - b).norm() / b.norm()) < 2e-2


def test_oracle_copy_equals_the_port():
    from tpupose_torch.tracking import oracle as port_oracle
    from tpupose_torch.data.synthetic import make_continuous_adversarial_scene

    sc = make_continuous_adversarial_scene(num_frames=40, num_actors=4, fp_per_view=1,
                                           drop_prob=0.1, seed=11)
    dets, mask = generate.padded_detections(sc, 16)
    from tpupose_torch.geometry import make_camera_set

    cams = make_camera_set(sc.P, sc.K, sc.RT, sc.width, sc.height)
    theirs = port_oracle.OracleTracker(
        port_oracle.OracleTracker.make_cameras(*(np.asarray(getattr(cams, f))
                                                 for f in ("P", "F", "rk_inv", "center"))),
        port_oracle.TrackerParams(max_tracks=16))
    ours = oracle.OracleTracker(oracle.rig(sc.P, sc.K, sc.RT), oracle.TrackerParams(max_tracks=16))
    a = judge.reference_frames(theirs, dets, mask)
    b = judge.reference_frames(ours, dets, mask)
    assert [sorted(f) for f in a] == [sorted(f) for f in b]
    assert sum(len(f) for f in a) > 0
    for fa, fb in zip(a, b):
        for k in fa:
            np.testing.assert_allclose(fa[k], fb[k], atol=1e-4)


def test_scene_copy_equals_the_port():
    from tpupose_torch.data import synthetic

    kw = dict(num_frames=50, num_cameras=5, num_actors=4, noise_px=1.5, seed=2**31 + 9,
              occlusion_px=60.0, fp_per_view=1, drop_prob=0.1)
    a = synthetic.make_continuous_adversarial_scene(**kw)
    b = scene.make_continuous_adversarial_scene(**kw)
    for field in ("P", "K", "RT", "gt3d", "detections", "visible"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    for got, want in zip(scene.camera_ring(5, w=1032, h=776),
                         synthetic.camera_ring(5, w=1032, h=776)):
        assert np.array_equal(got, want)


def test_tracker_numbers_match_by_pose_not_id():
    pose = np.zeros((17, 3))
    seq = [({5: pose}, {0: pose + 1e-4}), ({5: pose}, {0: pose}), ({5: pose}, {1: pose})]
    n = judge.tracker_numbers([seq])
    assert n["track_unmatched_share"] == 0.0 and n["track_id_switches"] == 1
    assert n["track_pose_gap_m"] == pytest.approx(1e-4)
    n = judge.tracker_numbers([[({5: pose}, {})]])
    assert n["track_unmatched_share"] == 1.0


def test_count_of_a_few_convs_by_hand():
    from benchmark.count import ops

    specs = [nets.ConvSpec("a", 3, 8, 3, 2, "bn"), nets.ConvSpec("b", 8, 4, 1, 1, None)]

    def forward(conv, x):
        return conv("b", conv("a", x))

    items = ops.conv_items(specs, forward, (2, 3, 10, 12), "t", {"b"})
    # a: 2 x 8 x 5 x 6 outputs, 27 MACs each; b: 2 x 4 x 5 x 6 outputs, 8 MACs each
    assert [i["ops"] for i in items] == [2 * 2 * 8 * 5 * 6 * 27, 2 * 2 * 4 * 5 * 6 * 8]
    assert items[0]["bytes"] == 2 * (2 * 3 * 10 * 12) + 2 * (8 * 3 * 9) + 2 * (2 * 8 * 5 * 6)
    assert items[1]["bytes"] == 2 * (2 * 8 * 5 * 6) + 1 * (4 * 8) + 2 * (2 * 4 * 5 * 6)
    assert [i["precision"] for i in items] == ["bf16", "int8"]


def test_count_of_the_published_networks():
    from benchmark.count import ops

    cfg = tiny_config("bf16")
    cfg["detector"].update(num_classes=80, input_size=416, width_mult=1.0, max_candidates=1)
    cfg["pose"].update(width=48, input_size=[384, 288], stem_channels=64, layer1_blocks=4,
                       layer1_planes=64, stage_modules=[1, 4, 3], stage_blocks=4)
    cfg["rig"].update(views=1, height=776, width=1032)
    items = ops.frame_work(cfg)
    macs = {net: sum(i["ops"] for i in items if i["net"] == net) / 2 for net in ("yolov3", "hrnet")}
    # darknet's 65.86 BFLOPs for YOLOv3-416 (two operations a multiply-add)
    assert macs["yolov3"] * 2 / 1e9 == pytest.approx(65.86, abs=0.01)
    # pose_hrnet_w48 at 384x288: published as 32.9 G; this count holds every conv
    assert macs["hrnet"] / 1e9 == pytest.approx(35.31, abs=0.01)
