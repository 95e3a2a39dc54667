"""ViTPose in the port (`models/vitpose.py`, `ops/attention.py`), against
the plain forward of `tests/plain_vitpose.py`, on the CPU at the tiny
config.

* The module in float32 against the plain forward on seeded weights with
  every term live (biases, LayerNorm affines, BN statistics): within
  rtol 1e-5 / atol 1e-5 (measured 1.4e-6 on heatmaps of |6.5|): float32
  products of a few dozen terms summed in another order, the attention's
  softmax by another route. Folded (`layers.fold_batchnorm`) and fed a
  channels-last view, as served: the same.
* The ViT-H key set and shapes on the meta device against
  `tests/fixtures/vitpose_h_256x192.keys.txt` (the published module
  names); a checkpoint in the official layout loads strictly through the
  registry's "vitpose", and a key short refuses to load.
* `fold_batchnorm` on a transposed conv + BN equals the unfolded pair
  (rtol 1e-5 / atol 1e-6: the scale folded into the weight before the
  products, not after); a conv + BN folds to the formula's bits, as
  before transposed convs were folded.
* `Pipeline.process_clip_nn` with tiny YOLOv3 and tiny ViTPose in float32
  gives the plain chain's keypoints (the pipeline's own boxes and crops,
  the plain forward, K1's plain decode): equal masks, keypoints within
  1e-3 px.
* The plain attention against its formula; the dispatch sends a CPU
  tensor there.
* `pack_models`, `quantize_models`, the CLI's `--int8` and `--bundle` and
  a bundle's conversion refuse a ViTPose net with an error that names it.
* The spans `stage_a.vitpose.blocks` and `stage_a.vitpose.head` appear
  once a forward, nested in `stage_a.hrnet`.
* On the card (marked `card`): ViT-H at full width in bf16 through
  `process_clip_nn` against the plain float32 forward on 2 images, and 32
  fused attention calls a forward. Run it there with
  `python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_vitpose.py`
  (the tests' conftest imports JAX, which a card host need not have).
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import tpupose_torch.models.vitpose as tv
import tpupose_torch.models.yolov3 as ty
import tpupose_torch.pipeline.facade as facade
from tests.plain_vitpose import vitpose_forward
from tpupose_torch.data.synthetic import make_scene
from tpupose_torch.geometry import make_camera_set
from tpupose_torch.models.layers import BatchNorm2d, fold_batchnorm
from tpupose_torch.ops import attention as tattn
from tpupose_torch.ops.heatmap import decode_heatmaps
from tpupose_torch.pipeline import Pipeline
from tpupose_torch.tracking.tracker import TrackerConfig
from tpupose_torch.utils import timing

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TRACK = dict(num_cameras=3, max_dets=8, max_tracks=8, max_hyp=16)


def _live(model, seed=1, scale=0.05):
    """`model` with every term live: weights and biases moved off their
    initialization by N(0, scale), BN statistics and affines away from the
    identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.copy_(0.8 + 0.4 * torch.rand(b.shape, generator=gen))
            elif name.endswith("running_mean"):
                b.copy_(0.05 * torch.randn(b.shape, generator=gen))
    return model.eval()


def _tiny(seed=0):
    cfg = tv.tiny_vitpose_config()
    return cfg, _live(tv.vitpose_init(cfg, torch.Generator().manual_seed(seed)))


def test_module_equals_the_plain_forward():
    cfg, model = _tiny()
    x = torch.randn(3, 3, *cfg.input_size, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = vitpose_forward(model.state_dict(), x, cfg.num_heads)
        got = model(x, torch.float32)
        assert got.dtype == torch.float32 and got.shape == (3, 17, *cfg.heatmap_size)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        served = fold_batchnorm(model)(x.contiguous(memory_format=torch.channels_last),
                                       torch.float32)
    torch.testing.assert_close(served, ref, rtol=1e-5, atol=1e-5)


def _fixture_keys():
    rows = {}
    for line in (ROOT / "tests" / "fixtures" / "vitpose_h_256x192.keys.txt").read_text() \
            .splitlines():
        if line and not line.startswith("#"):
            name, shape = line.split()
            rows[name] = () if shape == "scalar" else tuple(int(s) for s in shape.split("x"))
    return rows


def test_vitpose_h_keys_and_shapes_are_the_published_ones():
    cfg = tv.vitpose_h_config()
    assert cfg.patch_grid == (16, 12) and cfg.num_patches == 192
    assert cfg.heatmap_size == (64, 48)
    with torch.device("meta"):
        model = tv.ViTPose(cfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == _fixture_keys()
    assert list(got) == list(_fixture_keys())
    assert sum(p.numel() for p in model.parameters()) == 637_208_849


def test_official_checkpoint_loads_through_the_registry(tmp_path):
    import tpupose_torch.pipeline.registry_defs  # noqa: F401  (fills the registries)
    from tpupose_torch.data.config import PoseModelConfig
    from tpupose_torch.utils.registry import POSE_MODELS

    cfg, model = _tiny()
    sd = model.state_dict()
    path = tmp_path / "vitpose_tiny.pth"
    torch.save({"meta": {"epoch": 210}, "state_dict": sd}, path)
    pcfg = PoseModelConfig(name="ViTPose", checkpoint_file=str(path), resolution=(64, 48),
                           embed_dim=32, depth=2, num_heads=4)
    pose_cfg, loaded = POSE_MODELS.get("ViTPose")(pcfg)
    assert pose_cfg == cfg
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    short = {k: v for k, v in sd.items() if k != "backbone.last_norm.bias"}
    torch.save({"state_dict": short}, path)
    with pytest.raises(RuntimeError, match="last_norm.bias"):
        POSE_MODELS.get("vitpose")(pcfg)


@pytest.mark.parametrize("kind", ["deconv", "conv"])
def test_fold_batchnorm(kind):
    gen = torch.Generator().manual_seed(3)
    conv = (nn.ConvTranspose2d(16, 8, 4, stride=2, padding=1, bias=False) if kind == "deconv"
            else nn.Conv2d(16, 8, 3, padding=1, bias=False))
    model = _live(nn.Sequential(conv, BatchNorm2d(8)))
    w0 = conv.weight.detach().clone()
    bn = model[1]
    x = torch.randn(2, 16, 6, 5, generator=gen)
    with torch.no_grad():
        ref = model(x)
        s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        b = bn.bias.float() - bn.running_mean.float() * s
        fold_batchnorm(model)
        assert isinstance(model[1], nn.Identity)
        if kind == "conv":  # the formula's bits, as ever
            assert torch.equal(conv.weight, w0 * s[:, None, None, None])
        else:
            assert torch.equal(conv.weight, w0 * s[None, :, None, None])
        assert torch.equal(conv.bias, b)
        torch.testing.assert_close(model(x), ref, rtol=1e-5, atol=1e-6)


def _pipeline(compute_dtype=torch.float32):
    scene = make_scene(num_frames=1, num_cameras=3, num_actors=2, seed=0)
    gen = torch.Generator().manual_seed(0)
    det_cfg = ty.tiny_yolo_test_config()
    pose_cfg, pose = _tiny()
    return Pipeline(make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height),
                    TrackerConfig(**TRACK), det_cfg, ty.yolov3_init(det_cfg, gen), pose_cfg,
                    fold_batchnorm(pose), device="cpu", compute_dtype=compute_dtype), pose


def _clip(frames=2):
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, 255, size=(frames, 3, 96, 128, 3), dtype=np.uint8))


def test_process_clip_nn_gives_the_plain_chain():
    pipe, _ = _pipeline()
    unfolded = _tiny()[1].state_dict()
    clip = _clip()
    dets, mask = pipe.process_clip_nn(clip)
    f, c = clip.shape[:2]
    images = clip.reshape(f * c, *clip.shape[2:])
    with torch.no_grad():
        x = images.to(torch.bfloat16) / 255.0
        boxes, _, valid = ty.detect_people(pipe.detector, pipe.det_cfg,
                                           ty.prepare_yolo_images(pipe.det_cfg, x),
                                           images.shape[1:3], torch.float32)
        eboxes, crops = facade._pose_crops(pipe.pose_cfg, x, boxes)
        heat = vitpose_forward(unfolded, crops, pipe.pose_cfg.num_heads)
        kps = decode_heatmaps(heat, eboxes, refine="quarter")
    k = boxes.shape[1]
    d = min(k, mask.shape[-1])  # the tracker takes the first max_dets candidates
    assert valid[:, :d].any()
    assert torch.equal(mask.reshape(f * c, -1)[:, :d], valid[:, :d])
    torch.testing.assert_close(dets.reshape(f * c, -1, 17, 3)[:, :d],
                               kps.reshape(f * c, k, 17, 3)[:, :d], rtol=0, atol=1e-3)


def test_plain_attention_is_its_formula():
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 3, 7, 5, generator=gen) for _ in range(3))
    scale = 5 ** -0.5
    w = torch.exp(torch.einsum("bhtd,bhsd->bhts", q, k) * scale)
    ref = torch.einsum("bhts,bhsd->bhtd", w / w.sum(-1, keepdim=True), v)
    before = tattn.launches
    torch.testing.assert_close(tattn.attention(q, k, v, scale), ref, rtol=1e-6, atol=1e-6)
    got = tattn.attention_plain(*(t.to(torch.bfloat16) for t in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16 and tattn.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tattn.attention_cuda(q, k, v, scale)


def test_hrnet_only_paths_refuse_vitpose(tmp_path):
    from tpupose_torch.cli import common
    from tpupose_torch.cli.convert import convert_checkpoints
    from tpupose_torch.data.config import load_config

    pipe, _ = _pipeline(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ViTPose"):
        pipe.pack_models()
    with pytest.raises(NotImplementedError, match="ViTPose"):
        pipe.quantize_models(_clip(8).reshape(-1, 96, 128, 3)[:8])
    cfg = load_config(str(ROOT / "configs" / "Shelf" / "model_configs.yaml"))
    cfg.pipeline.pose_model = "ViTPose"
    assert common.pose_config_from(cfg) == tv.ViTPoseConfig(input_size=(384, 288))
    for kw in ({"bundle": str(tmp_path)}, {"int8": True}):
        with pytest.raises(NotImplementedError, match="ViTPose"):
            common.build_pipeline_real(cfg, None, 1032, 776, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ViTPose"):
        convert_checkpoints(cfg, str(tmp_path))


def test_vitpose_spans_nest_in_the_pose_span():
    pipe, _ = _pipeline(torch.bfloat16)
    pipe.process_clip_nn(_clip())
    timing.clear_spans()
    try:
        with timing.recording():
            pipe.process_clip_nn(_clip())
        records = timing.spans()
    finally:
        timing.clear_spans()
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    pose = by_name["stage_a.hrnet"]
    assert len(pose) == 1
    for name in ("stage_a.vitpose.blocks", "stage_a.vitpose.head"):
        assert len(by_name[name]) == 1, name
        assert by_name[name][0].parent == pose[0].id, name
    blocks, head = by_name["stage_a.vitpose.blocks"][0], by_name["stage_a.vitpose.head"][0]
    assert pose[0].start_ns <= blocks.start_ns <= blocks.end_ns <= head.start_ns \
        <= head.end_ns <= pose[0].end_ns


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_full_width_vitpose_h_on_the_card(card):
    """ViT-H in bf16 through the served stage A against the plain float32
    forward on the same crops: the heatmaps within 5% relative L2 (bf16
    keeps 8 bits a value; the residual stream's rounding over 32 blocks
    measured 1-2% on the card) and every keypoint's argmax cell one whose
    plain heatmap lies within 5% of the map's range of its maximum."""
    cfg = tv.vitpose_h_config()
    det_cfg = ty.YoloConfig(max_candidates=2)
    gen = torch.Generator().manual_seed(0)
    pose = _live(tv.vitpose_init(cfg, gen), seed=5, scale=0.01)
    unfolded = {k: v.to(card) for k, v in pose.state_dict().items()}
    det = fold_batchnorm(ty.yolov3_init(det_cfg, gen), dtype=torch.bfloat16)
    scene = make_scene(num_frames=1, num_cameras=2, num_actors=2, seed=0)
    pipe = Pipeline(make_camera_set(scene.P, scene.K, scene.RT, 320, 256),
                    TrackerConfig(num_cameras=2, max_dets=2), det_cfg, det, cfg,
                    fold_batchnorm(pose, dtype=torch.bfloat16), device=card)
    clip = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, size=(1, 2, 256, 320, 3), dtype=np.uint8), device=card)
    heats = []
    real = pipe.pose_model.forward

    def keep(crops, dtype):
        heats.append((crops.clone(), real(crops, dtype)))
        return heats[-1][1]

    pipe.pose_model.forward = keep
    before = tattn.launches
    dets, mask = pipe.process_clip_nn(clip)
    assert tattn.launches - before == cfg.depth
    crops, heat = heats[0]
    assert crops.shape == (4, 3, 256, 192) and heat.shape == (4, 17, 64, 48)
    with torch.no_grad():
        ref = vitpose_forward(unfolded, crops.float(), cfg.num_heads)
    rel = float(torch.linalg.vector_norm(heat - ref) / torch.linalg.vector_norm(ref))
    print(f"ViT-H bf16 heatmaps against float32: relative L2 {rel:.3e}")
    assert rel < 0.05
    flat, got = ref.flatten(2), heat.flatten(2).argmax(-1)
    at = torch.gather(flat, 2, got[..., None])[..., 0]
    gap = (flat.amax(-1) - at) / (flat.amax(-1) - flat.amin(-1))
    print(f"argmax gap: max {float(gap.max()):.3e}, mean {float(gap.mean()):.3e}")
    assert float(gap.max()) < 0.05
    assert torch.isfinite(dets).all() and mask.shape == (1, 2, 2)
