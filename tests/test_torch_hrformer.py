"""HRFormer in the port (`models/hrformer.py`, the bias of `ops/attention.py`,
the GELU of `ops/epilogue.py`), against the plain forward of
`tests/plain_hrformer.py`, on the CPU at the tiny config.

* The module in float32 against the plain forward on seeded weights with
  every term live (biases, LayerNorm and BN affines, BN statistics, the
  relative position bias): within rtol 1e-5 / atol 1e-4 (measured 3e-5 on
  heatmaps of |42|: float32 sums in another order through 9 blocks, the
  softmax by another route). Folded (`layers.fold_batchnorm`, which pairs the FFN's convs with
  their `normK` by `CrossFFN.bn_pairs`) and fed a channels-last view, as
  served: the same.
* One HRFormer-B-wide block (C 78, 2 heads of 39, window 7) on a 12x9 map;
  the centred pad and windows and their inverse at 12x9 and 48x36; the
  relative position index against mmpose's construction; a fuse module's
  bilinear rows; the attention with a bias at d = 39, and its zero padding
  to 40 (exact on dyadic inputs; the served weights pad each head so, the
  CPU's too, within rounding of the plain block).
* Planted faults fail the module comparison by far: no bias, the padding at
  the map's corner, a nearest upsample in the fuse, GELU before BN.
* HRFormer-B on the meta device: 43,211,777 parameters, 44 blocks, the
  published widths and sizes, mmpose's key names.
* `Pipeline.process_clip_nn` with tiny YOLOv3 and tiny HRFormer in float32
  gives the plain chain's keypoints; `pack_models`, `quantize_models` and
  the multi-stream clip function refuse an HRFormer net by name; the spans
  `stage_a.hrformer.attn` and `.ffn` appear once a block, nested in
  `stage_a.hrnet`.
* On the card (marked `card`): HRFormer-B at full width in bf16 through
  `process_clip_nn` against the plain float32 forward on 2 images, and 44
  fused attention calls a forward. Run it there with
  `python -m pytest --noconftest -p no:cacheprovider -m card -s tests/test_torch_hrformer.py`
  (the tests' conftest imports JAX, which a card host need not have).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import tests.plain_hrformer as plain
import tpupose_torch.models.hrformer as hf
import tpupose_torch.models.yolov3 as ty
import tpupose_torch.pipeline.facade as facade
from tpupose_torch.data.synthetic import make_scene
from tpupose_torch.geometry import make_camera_set
from tpupose_torch.models.layers import fold_batchnorm
from tpupose_torch.ops import attention as tattn
from tpupose_torch.ops.heatmap import decode_heatmaps
from tpupose_torch.pipeline import Pipeline
from tpupose_torch.tracking.tracker import TrackerConfig
from tpupose_torch.utils import timing

torch.set_num_threads(1)
TRACK = dict(num_cameras=3, max_dets=8, max_tracks=8, max_hyp=16)
TOL = dict(rtol=1e-5, atol=1e-4)


def _live(model, seed=1, scale=0.05):
    """`model` with every term live: parameters moved off their
    initialization by N(0, scale), the bias tables by N(0, 0.5), BN
    statistics away from the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            s = 0.5 if name.endswith("relative_position_bias_table") else scale
            p.add_(s * torch.randn(p.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.copy_(0.8 + 0.4 * torch.rand(b.shape, generator=gen))
            elif name.endswith("running_mean"):
                b.copy_(0.05 * torch.randn(b.shape, generator=gen))
    return model.eval()


def _tiny(seed=0):
    cfg = hf.tiny_hrformer_config()
    return cfg, _live(hf.hrformer_init(cfg, torch.Generator().manual_seed(seed)))


def _input(cfg, n=2, seed=2):
    return torch.randn(n, 3, *cfg.input_size, generator=torch.Generator().manual_seed(seed))


def _plain(model, cfg, x):
    return plain.hrformer_forward(model.state_dict(), x, cfg.num_heads, cfg.window_size,
                                  cfg.ln_eps)


def test_module_equals_the_plain_forward():
    cfg, model = _tiny()
    x = _input(cfg, 3)
    with torch.no_grad():
        ref = _plain(model, cfg, x)
        got = model(x, torch.float32)
        assert got.dtype == torch.float32 and got.shape == (3, 17, *cfg.heatmap_size)
        torch.testing.assert_close(got, ref, **TOL)
        served = fold_batchnorm(model)
        assert not any(isinstance(m, nn.BatchNorm2d) for m in served.modules())
        got = served(x.contiguous(memory_format=torch.channels_last), torch.float32)
    torch.testing.assert_close(got, ref, **TOL)


def _block(c=78, heads=2, window=7, seed=3):
    block = hf.HRFormerBlock(c, heads, window, 4, 1e-6)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0, (1 / m.weight[0].numel()) ** 0.5, generator=gen)
        wrapper = nn.Module()
        wrapper.b = block
    return _live(wrapper, seed).b


def _plain_net(cfg_heads=(2,), window=7):
    return plain._Net(None, cfg_heads, window, 1e-6, 1e-5)


def test_one_block_equals_the_plain_block():
    block = _block()
    x = torch.randn(2, 78, 12, 9, generator=torch.Generator().manual_seed(4))
    net = _plain_net()
    net.sd = {"b." + k: v for k, v in block.state_dict().items() if v.is_floating_point()}
    with torch.no_grad():
        ref = net.block(x, "b", 2)
        got = block(x.contiguous(memory_format=torch.channels_last))
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("hw", [(12, 9), (48, 36), (14, 7)])
def test_centred_partition_and_its_inverse(hw):
    h, w = hw
    ws, c = 7, 5
    t = torch.randn(2, h * w, c, generator=torch.Generator().manual_seed(5))
    ph, pw = -h % ws, -w % ws
    padded = F.pad(t.view(2, h, w, c), (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    hp, wp = h + ph, w + pw
    ref = padded.view(2, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(
        2, -1, c)
    got = hf.partition(t, h, w, ws)
    assert torch.equal(got, ref)
    assert torch.equal(hf.unpartition(got, h, w, ws), t)
    idx = hf.window_index(h, w, ws, t.device)
    assert idx.pad.numel() == hp * wp - h * w


@pytest.mark.parametrize("window", [3, 7])
def test_relative_position_index_is_the_published_one(window):
    got = hf.relative_position_index(window)
    assert torch.equal(got, plain.published_index(window))
    if window == 7:
        i, j = 3 * 7 + 5, 6 * 7 + 0  # (3, 5) and (6, 0)
        assert int(got[i, j]) == (3 - 6 + 6) * 13 + (5 - 0 + 6)
    assert torch.equal(hf.WindowMSA(12, 2, window).relative_position_index, got)


def _module(n_branches=3, seed=6):
    cfg = hf.HRFormerConfig(branch_channels=(6, 12, 18, 24), num_heads=(2, 2, 3, 4),
                            stage_blocks=1, window_size=3)
    wrapper = nn.Module()
    wrapper.m = hf.HRFormerModule(cfg, n_branches, n_branches)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in wrapper.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0, (1 / m.weight[0].numel()) ** 0.5, generator=gen)
    return cfg, _live(wrapper, seed).m


def _module_inputs(cfg, n_branches):
    gen = torch.Generator().manual_seed(7)
    return [torch.randn(2, c, 16 >> b, 8 >> b, generator=gen).contiguous(
        memory_format=torch.channels_last) for b, c in enumerate(cfg.branch_channels[:n_branches])]


def test_fuse_rows_upsample_bilinearly():
    x = torch.randn(2, 5, 3, 2, generator=torch.Generator().manual_seed(8))
    for f in (2, 4, 8):
        torch.testing.assert_close(
            F.interpolate(x, scale_factor=f, mode="bilinear", align_corners=False),
            plain.upsample_bilinear(x, f), rtol=1e-6, atol=1e-6)
    cfg, module = _module()
    xs = _module_inputs(cfg, 3)
    net = _plain_net(cfg.num_heads, cfg.window_size)
    net.sd = {"m." + k: v for k, v in module.state_dict().items() if v.is_floating_point()}
    with torch.no_grad():
        ref = net.module(xs, "m")
        got = module(xs)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL)


def test_attention_with_a_bias_at_head_dim_39():
    gen = torch.Generator().manual_seed(9)
    b, heads, t, d = 3, 2, 49, 39
    q, k, v = (torch.randn(b, heads, t, d, generator=gen) for _ in range(3))
    bias = torch.randn(heads, t, t, generator=gen)
    scale = d ** -0.5
    w = torch.exp(torch.einsum("bhtd,bhsd->bhts", q, k) * scale + bias)
    ref = torch.einsum("bhts,bhsd->bhtd", w / w.sum(-1, keepdim=True), v)
    torch.testing.assert_close(tattn.attention(q, k, v, scale, bias), ref, rtol=1e-5,
                               atol=1e-6)
    # zero-padded to d = 40 with the scale of 39: exact, shown on dyadic
    # inputs whose every sum is exact in float32
    q, k, v = (torch.randint(-8, 8, (b, heads, t, d), generator=gen).float() / 8
               for _ in range(3))
    padded = tattn.attention_plain(*(F.pad(x, (0, 1)) for x in (q, k, v)), scale, bias)
    assert torch.equal(padded[..., :d], tattn.attention_plain(q, k, v, scale, bias))
    assert torch.equal(padded[..., d:], torch.zeros_like(padded[..., d:]))
    aligned = tattn.pad_bias(bias)
    assert torch.equal(aligned, bias) and aligned.stride(-2) == 56


def test_served_weights_pad_each_head_to_40():
    block = _block()
    s = block.attn.attn.served(torch.float32, torch.device("cpu"))
    assert s.qkv_w.shape == (3 * 2 * 40, 78) and s.proj_w.shape == (78, 80)
    assert torch.equal(s.qkv_w.view(3, 2, 40, 78)[:, :, 39:], torch.zeros(3, 2, 1, 78))
    assert torch.equal(s.qkv_b.view(3, 2, 40)[:, :, 39:], torch.zeros(3, 2, 1))
    assert torch.equal(s.proj_w.view(78, 2, 40)[:, :, 39:], torch.zeros(78, 2, 1))
    assert s.bias.shape == (2, 49, 49) and s.bias.stride(-2) == 56
    assert block.attn.attn.served(torch.float32, torch.device("cpu")) is s


# -- planted faults ------------------------------------------------------------

def _corner_index(h, w, window, device):
    """A window index padded after the map alone (no centring)."""
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
    from tpupose_torch.models.layers import bn_apply

    for conv, bn in ((self.fc1, self.norm1), (self.dw3x3, self.norm2), (self.fc2, self.norm3)):
        x = bn_apply(bn, F.gelu(conv(x)))
    return skip + x


FAULTS = {
    "no_bias": lambda m: m.setattr(
        hf, "attention", lambda q, k, v, scale, bias: tattn.attention(q, k, v, scale)),
    "corner_padding": lambda m: m.setattr(hf, "window_index", _corner_index),
    "nearest_upsample": lambda m: m.setattr(hf.F, "interpolate", lambda x, scale_factor, mode,
                                            align_corners: torch.repeat_interleave(
                                                torch.repeat_interleave(x, scale_factor, 2),
                                                scale_factor, 3)),
    "gelu_before_bn": lambda m: m.setattr(hf.CrossFFN, "forward", _gelu_before_bn),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_comparison(fault, monkeypatch):
    cfg, model = _tiny()
    x = _input(cfg)
    with torch.no_grad():
        ref = _plain(model, cfg, x)
        with monkeypatch.context() as m:
            FAULTS[fault](m)
            got = model(x, torch.float32)
    err = float((got - ref).abs().max())
    print(fault, err)
    assert err > 100 * (TOL["atol"] + TOL["rtol"] * float(ref.abs().max())), (fault, err)


# -- HRFormer-B ----------------------------------------------------------------

def test_hrformer_b_is_the_published_network():
    cfg = hf.hrformer_b_config()
    assert cfg.branch_sizes == [(96, 72), (48, 36), (24, 18), (12, 9)]
    with torch.device("meta"):
        model = hf.HRFormer(cfg)
    sd = model.state_dict()
    assert sum(p.numel() for p in model.parameters()) == 43_211_777
    blocks = [m for m in model.modules() if isinstance(m, hf.HRFormerBlock)]
    assert len(blocks) == 44
    assert {b.attn.attn.head_dim for b in blocks} == {39}
    assert sum(b.norm1.normalized_shape == (78,) for b in blocks) == 14
    for key, shape in {
            "backbone.conv1.weight": (64, 3, 3, 3),
            "backbone.layer1.1.conv3.weight": (256, 64, 1, 1),
            "backbone.transition1.0.0.weight": (78, 256, 3, 3),
            "backbone.transition3.3.0.0.weight": (624, 312, 3, 3),
            "backbone.stage2.0.branches.0.0.attn.attn.relative_position_bias_table": (169, 2),
            "backbone.stage4.1.branches.3.1.attn.attn.qkv.weight": (1872, 624),
            "backbone.stage3.3.branches.1.1.ffn.dw3x3.weight": (624, 1, 3, 3),
            "backbone.stage3.0.branches.2.0.ffn.norm3.running_var": (312,),
            "backbone.stage3.0.fuse_layers.2.0.1.2.weight": (312, 78, 1, 1),
            "backbone.stage4.1.fuse_layers.0.3.0.weight": (78, 624, 1, 1),
            "keypoint_head.final_layer.weight": (17, 78, 1, 1)}.items():
        assert tuple(sd[key].shape) == shape, key
    assert tuple(sd["backbone.stage2.0.branches.0.0.attn.attn.relative_position_index"]
                 .shape) == (49, 49)
    assert not any(k.startswith("backbone.stage4.1.fuse_layers.1") for k in sd)


def test_hrformer_b_epilogue_and_attention_sites(monkeypatch):
    """HRFormer-B served in bf16 on one crop, with the card's rule (a float
    conv's bias in the epilogue) forced on the CPU: the epilogue at 233
    call sites (chip_smoke's HRFORMER_LAUNCHES less YOLOv3's 72), every
    one at any width, and the attention once a block."""
    import tpupose_torch.models.layers as tl
    from tpupose_torch.ops import epilogue

    cfg = hf.hrformer_b_config()
    model = fold_batchnorm(hf.hrformer_init(cfg, torch.Generator().manual_seed(0)),
                           dtype=torch.bfloat16)
    calls = {"epilogue": 0, "attention": 0, "widths": set()}
    dispatch, attend = epilogue.bias_act, hf.attention

    def bias_act(src, *args):
        out = dispatch(src, *args)
        calls["epilogue"] += out is not src
        calls["widths"].add(src.shape[1])
        return out

    def attention(*args):
        calls["attention"] += 1
        return attend(*args)

    monkeypatch.setattr(epilogue, "bias_act", bias_act)
    monkeypatch.setattr(tl, "bias_in_epilogue", lambda device: True)
    monkeypatch.setattr(hf, "attention", attention)
    x = torch.randn(1, 3, *cfg.input_size, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        heat = model(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
    assert heat.shape == (1, 17, 96, 72) and torch.isfinite(heat).all()
    assert calls["epilogue"] == 233 and calls["attention"] == 44
    assert {78, 156, 312, 624} <= calls["widths"]


# -- the served path -----------------------------------------------------------

def _pipeline(compute_dtype=torch.float32):
    scene = make_scene(num_frames=1, num_cameras=3, num_actors=2, seed=0)
    gen = torch.Generator().manual_seed(0)
    det_cfg = ty.tiny_yolo_test_config()
    pose_cfg, pose = _tiny()
    return Pipeline(make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height),
                    TrackerConfig(**TRACK), det_cfg, ty.yolov3_init(det_cfg, gen), pose_cfg,
                    fold_batchnorm(pose), device="cpu", compute_dtype=compute_dtype)


def _clip(frames=2):
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, 255, size=(frames, 3, 96, 128, 3), dtype=np.uint8))


def test_process_clip_nn_gives_the_plain_chain():
    pipe = _pipeline()
    cfg, unfolded = _tiny()
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
        heat = _plain(unfolded, cfg, crops)
        kps = decode_heatmaps(heat, eboxes, refine="quarter")
    k = boxes.shape[1]
    d = min(k, mask.shape[-1])
    assert valid[:, :d].any()
    assert torch.equal(mask.reshape(f * c, -1)[:, :d], valid[:, :d])
    torch.testing.assert_close(dets.reshape(f * c, -1, 17, 3)[:, :d],
                               kps.reshape(f * c, k, 17, 3)[:, :d], rtol=0, atol=1e-3)


def test_hrnet_only_paths_refuse_hrformer():
    from tpupose_torch.parallel.throughput import make_multistream_clip_fn

    pipe = _pipeline(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="HRFormer"):
        pipe.pack_models()
    with pytest.raises(NotImplementedError, match="HRFormer"):
        pipe.quantize_models(_clip(8).reshape(-1, 96, 128, 3)[:8])
    with pytest.raises(NotImplementedError, match="HRFormer"):
        make_multistream_clip_fn(pipe.det_cfg, pipe.pose_cfg, pipe.tracker_cfg)


def test_hrformer_spans_nest_in_the_pose_span():
    pipe = _pipeline(torch.bfloat16)
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
    blocks = sum(1 for m in pipe.pose_model.modules() if isinstance(m, hf.HRFormerBlock))
    assert blocks == 2 + 3 + 4
    for name in ("stage_a.hrformer.attn", "stage_a.hrformer.ffn"):
        assert len(by_name[name]) == blocks, name
        for r in by_name[name]:
            assert r.parent == pose[0].id, name
            assert pose[0].start_ns <= r.start_ns <= r.end_ns <= pose[0].end_ns


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_full_width_hrformer_b_on_the_card(card):
    """HRFormer-B in bf16 through the served stage A against the plain
    float32 forward on the same crops: the heatmaps within 5% relative L2
    and every keypoint's argmax cell one whose plain heatmap lies within 5%
    of the map's range of its maximum; 44 fused attention calls."""
    cfg = hf.hrformer_b_config()
    det_cfg = ty.YoloConfig(max_candidates=2)
    gen = torch.Generator().manual_seed(0)
    pose = _live(hf.hrformer_init(cfg, gen), seed=5, scale=0.01)
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
    assert tattn.launches - before == 44
    crops, heat = heats[0]
    assert crops.shape == (4, 3, 384, 288) and heat.shape == (4, 17, 96, 72)
    with torch.no_grad():
        ref = plain.hrformer_forward(unfolded, crops.float(), cfg.num_heads)
    rel = float(torch.linalg.vector_norm(heat - ref) / torch.linalg.vector_norm(ref))
    print(f"HRFormer-B bf16 heatmaps against float32: relative L2 {rel:.3e}")
    assert rel < 0.05
    flat, got = ref.flatten(2), heat.flatten(2).argmax(-1)
    at = torch.gather(flat, 2, got[..., None])[..., 0]
    gap = (flat.amax(-1) - at) / (flat.amax(-1) - flat.amin(-1))
    print(f"argmax gap: max {float(gap.max()):.3e}, mean {float(gap.mean()):.3e}")
    assert float(gap.max()) < 0.05
    assert torch.isfinite(dets).all() and mask.shape == (1, 2, 2)


@pytest.mark.card
def test_attention_with_a_bias_on_the_card(card):
    """The fused attention with a (heads, 49, 49) bias at d = 39 (padded to
    40 inside the call) and at 40 against the plain version, in bf16."""
    gen = torch.Generator(device=card).manual_seed(0)
    for d in (39, 40):
        q, k, v = (torch.randn(640, 2, 49, d, generator=gen, device=card).to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.randn(2, 49, 49, generator=gen, device=card).to(torch.bfloat16)
        before = tattn.launches
        got = tattn.attention_cuda(q, k, v, 39 ** -0.5, bias)
        assert tattn.launches - before == 1 and got.shape == q.shape
        ref = tattn.attention_plain(q, k, v, 39 ** -0.5, bias)
        err = float((got.float() - ref.float()).abs().max())
        print(f"d {d}: max |fused - plain| {err:.3e}")
        assert err < 2e-2
