"""The one-pass conv epilogue (`tpupose_torch.ops.epilogue`, called through
`models.layers.conv_out` / `finish`).

* The plain version is bit for bit the composed ops it replaces, in every
  mode: bias or none, the skip after or before the activation or none,
  none / ReLU / leaky ReLU, a src upsampled 0-3 times, bf16 and f32,
  channels-last, NaN and infinities included.
* Served (inference mode, channels-last, BN folded), the tiny HRNet (float,
  packed branch 0, int8, int8-resident) and YOLOv3 (float, int8) give
  outputs `torch.equal` to the composed forwards the networks had before the
  epilogue (`COMPOSED`, patched in).
* With a float conv's bias taken into the epilogue (the card's rule,
  `layers.bias_in_epilogue`, forced here on the CPU) the epilogue runs once
  at every engaged call site, and the f32 forward stays within rounding of
  the composed one.
* Under autograd nothing engages: forward and gradients equal the composed
  path's, and the epilogue is never called.
* The GELU mode (exact erf, HRFormer's FFN) is bit for bit the composed
  bias add, `F.gelu` and skip add, with the skip after or before it or
  none, bf16 and f32; the flat mode takes any width without an upsample
  where the output holds 8k elements, each vector's channels repeating with
  the period the kernel's grid keeps.
* On the card (marked `card`): the kernel bit for bit against the plain
  version at HRNet-W48's branch 0, a fuse-upsample shape and YOLOv3-416's
  (160, 256, 52, 52), and in every mode at small shapes; a full-width bf16
  `Pipeline.process_clip_nn` and the heatmaps with the kernel and composed
  `torch.equal`; the launches a forward, one an engaged call site. Run them
  there with
  `python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_epilogue.py`
  (the tests' conftest imports JAX, which a card host need not have).
"""
import contextlib
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tpupose_torch.models.hrnet as th
import tpupose_torch.models.layers as tl
import tpupose_torch.models.quantize as tq
import tpupose_torch.models.yolov3 as ty
from tpupose_torch.ops import epilogue
from tpupose_torch.ops.packing import pack_hrnet_branch0, pack_width, unpack_width

torch.set_num_threads(1)


# -- the composed forwards, as the networks ran them before the epilogue ------

def _basic_forward(self, x, resident=False):
    if resident and th._fusable(self, ("conv1", "conv2"), ("bn1", "bn2")):
        return tq.quantized_basic_block(self, x)
    y = F.relu(self.bn1(self.conv1(x)))
    y = self.bn2(self.conv2(y))
    skip = x if self.downsample is None else self.downsample(x)
    return F.relu(y + skip)


def _bottleneck_forward(self, x, resident=False):
    if resident and th._fusable(self, ("conv1", "conv2", "conv3"), ("bn1", "bn2", "bn3")):
        return tq.quantized_bottleneck(self, x)
    y = F.relu(self.bn1(self.conv1(x)))
    y = F.relu(self.bn2(self.conv2(y)))
    y = self.bn3(self.conv3(y))
    skip = x if self.downsample is None else self.downsample(x)
    return F.relu(y + skip)


def _module_forward(self, xs, resident=False, pack0=False):
    ys = []
    for b, (branch, x) in enumerate(zip(self.branches, xs)):
        if pack0 and b == 0:
            x = pack_width(x)
        for block in branch:
            x = block(x, resident)
        if pack0 and b == 0:
            x = unpack_width(x)
        ys.append(x)
    outs = []
    for i, row in enumerate(self.fuse_layers):
        acc = None
        for j, yj in enumerate(ys):
            if j == i:
                y = yj
            elif j > i:
                y = tl.upsample_nearest(row[j](yj), 2 ** (j - i))
            else:
                y = yj
                chain = row[j]
                for k, step in enumerate(chain):
                    y = step(y)
                    if k != len(chain) - 1:
                        y = F.relu(y)
            acc = y if acc is None else acc + y
        outs.append(F.relu(acc))
    return outs


def _hrnet_forward(self, x, compute_dtype=torch.bfloat16):
    x = x.to(compute_dtype)
    x = F.relu(self.bn1(self.conv1(x)))
    x = F.relu(self.bn2(self.conv2(x)))
    resident, pack0 = self.cfg.int8_resident, self.cfg.pack_branch0
    for block in self.layer1:
        x = block(x, resident)
    xs = [F.relu(self.transition1[0](x)), F.relu(self.transition1[1](x))]
    for module in self.stage2:
        xs = module(xs, resident, pack0)
    xs = xs + [F.relu(self.transition2[2](xs[-1]))]
    for module in self.stage3:
        xs = module(xs, resident, pack0)
    xs = xs + [F.relu(self.transition3[3](xs[-1]))]
    for module in self.stage4:
        xs = module(xs, resident, pack0)
    return self.final_layer(xs[0]).to(torch.float32)


def _resident_basic(block, x):
    c1, c2 = block.conv1, block.conv2
    z = tq._dequant_conv(c2, tq._requant_conv(c1, c2, x), x.dtype)
    skip = x if block.downsample is None else block.downsample(x)
    return F.relu(z + skip)


def _resident_bottleneck(block, x):
    c1, c2, c3 = block.conv1, block.conv2, block.conv3
    out = tq._dequant_conv(c3, tq._requant_conv(c2, c3, tq._requant_conv(c1, c2, x)), x.dtype)
    skip = x if block.downsample is None else block.downsample(x)
    return F.relu(out + skip)


def _convblock_forward(self, x):
    y = self.conv(x)
    if self.act:
        y = F.leaky_relu(self.bn(y), negative_slope=0.1)
    return y


def _yolo_run(self, i, x):
    return getattr(self, f"conv{i}")(x)


def _yolo_forward(self, x, compute_dtype=torch.bfloat16):
    x = x.to(compute_dtype)

    def res_chain(x, i, n):
        for _ in range(n):
            x = x + self.run(i + 1, self.run(i, x))
            i += 2
        return x, i

    x = self.run(0, x)
    x = self.run(1, x); x, i = res_chain(x, 2, 1)
    x = self.run(i, x); x, i = res_chain(x, i + 1, 2)
    x = self.run(i, x); x, i = res_chain(x, i + 1, 8)
    route25 = x
    x = self.run(i, x); x, i = res_chain(x, i + 1, 8)
    route42 = x
    x = self.run(i, x); x, i = res_chain(x, i + 1, 4)
    for j in range(52, 57):
        x = self.run(j, x)
    branch_a = x
    det1 = self.run(58, self.run(57, x))
    x = tl.upsample_nearest(self.run(59, branch_a), 2)
    x = torch.cat([x, route42], dim=1)
    for j in range(60, 65):
        x = self.run(j, x)
    branch_b = x
    det2 = self.run(66, self.run(65, x))
    x = tl.upsample_nearest(self.run(67, branch_b), 2)
    x = torch.cat([x, route25], dim=1)
    for j in range(68, 73):
        x = self.run(j, x)
    det3 = self.run(74, self.run(73, x))
    return [d.to(torch.float32) for d in (det1, det2, det3)]


#: (owner, attribute, composed version) of every changed forward.
COMPOSED = [
    (th.BasicBlock, "forward", _basic_forward),
    (th.Bottleneck, "forward", _bottleneck_forward),
    (th.HighResolutionModule, "forward", _module_forward),
    (th.HRNet, "forward", _hrnet_forward),
    (tq, "quantized_basic_block", _resident_basic),
    (tq, "quantized_bottleneck", _resident_bottleneck),
    (ty.ConvBlock, "forward", _convblock_forward),
    (ty.YOLOv3, "run", _yolo_run),
    (ty.YOLOv3, "forward", _yolo_forward),
]


@contextlib.contextmanager
def composed(monkeypatch):
    """The networks' forwards as they were before the epilogue."""
    with monkeypatch.context() as m:
        for owner, name, fn in COMPOSED:
            m.setattr(owner, name, fn)
        yield


@contextlib.contextmanager
def counted(monkeypatch, bias_in_epilogue=False):
    """Counts the epilogue's calls that would launch the kernel (the plain
    version runs them); with `bias_in_epilogue`, float convs leave their
    bias to the epilogue, as on the card. Yields a dict whose "calls"
    grows."""
    count = {"calls": 0}
    dispatch = epilogue.bias_act

    def bias_act(src, bias=None, skip=None, up=0, act=None, act_first=False):
        out = dispatch(src, bias, skip, up, act, act_first)
        count["calls"] += out is not src
        return out

    with monkeypatch.context() as m:
        m.setattr(epilogue, "bias_act", bias_act)
        if bias_in_epilogue:
            m.setattr(tl, "bias_in_epilogue", lambda device: True)
        yield count


# -- the plain version against the composed ops -------------------------------

def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _planted(shape, dtype, gen):
    """Channels-last noise with NaN, infinities and signed zeros planted."""
    x = torch.randn(shape, generator=gen)
    flat = x.view(-1)
    flat[:6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, -1e-30])
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _composed_ops(src, bias, skip, up, act, act_first):
    """What the networks ran: the conv's bias added in place as PyTorch adds
    it after cuDNN's conv, the nearest upsample of a fuse term, the
    activation and the skip in the networks' own order of operands."""
    y = src.clone()
    if bias is not None:
        y.add_(bias.to(y.dtype).reshape(1, -1, 1, 1))
    if up:
        y = tl.upsample_nearest(y, 2 ** up)
    acts = {None: lambda t: t, "relu": F.relu,
            "leaky": lambda t: F.leaky_relu(t, negative_slope=0.1)}
    if skip is None:
        return acts[act](y)
    if act_first:
        return skip + acts[act](y)  # Darknet's shortcut
    return acts[act](skip + y)      # a residual block, a fuse sum


MODES = list(itertools.product(
    (torch.bfloat16, torch.float32), (False, True), (None, "after", "before"),
    (None, "relu", "leaky"), (0, 1, 2, 3)))


def _operands(dtype, with_bias, skip_mode, up, gen, shape=(2, 16, 16, 24)):
    n, c, h, w = shape
    src = _planted((n, c, h >> up, w >> up), dtype, gen)
    bias = torch.randn(c, generator=gen).to(dtype) if with_bias else None
    skip = None if skip_mode is None else _planted(shape, dtype, gen)
    return src, bias, skip


@pytest.mark.parametrize("dtype,with_bias,skip_mode,act,up", MODES)
def test_plain_is_the_composed_ops(dtype, with_bias, skip_mode, act, up):
    gen = torch.Generator().manual_seed(up + 4 * len(str(act)))
    src, bias, skip = _operands(dtype, with_bias, skip_mode, up, gen)
    act_first = skip_mode == "before"
    got = epilogue.bias_act_plain(src, bias, skip, up, act, act_first)
    ref = _composed_ops(src, bias, skip, up, act, act_first)
    assert got.shape == ref.shape == (2, 16, 16, 24)
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(_bits(epilogue.bias_act(src, bias, skip, up, act, act_first)),
                       _bits(ref))


def test_nothing_to_do_returns_src():
    src = torch.randn(1, 8, 2, 2).contiguous(memory_format=torch.channels_last)
    assert epilogue.bias_act(src) is src


def test_cuda_wrapper_refuses_cpu_tensors():
    src = torch.randn(1, 8, 2, 2).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="CUDA"):
        epilogue.bias_act_cuda(src, act="relu")


GELU_MODES = list(itertools.product(
    (torch.bfloat16, torch.float32), (False, True), (None, "after", "before"), (24, 78)))


def _composed_gelu(src, bias, skip, act_first):
    """HRFormer's FFN as composed ops: the conv's bias added in place, exact
    GELU, the block's residual added after it (or the GELU after the sum)."""
    y = src.clone()
    if bias is not None:
        y.add_(bias.to(y.dtype).reshape(1, -1, 1, 1))
    if skip is None:
        return F.gelu(y)
    return skip + F.gelu(y) if act_first else F.gelu(skip + y)


@pytest.mark.parametrize("dtype,with_bias,skip_mode,c", GELU_MODES)
def test_plain_gelu_is_the_composed_ops(dtype, with_bias, skip_mode, c):
    gen = torch.Generator().manual_seed(c + len(str(skip_mode)))
    src, bias, skip = _operands(dtype, with_bias, skip_mode, 0, gen, shape=(2, c, 6, 5))
    act_first = skip_mode == "before"
    got = epilogue.bias_act_plain(src, bias, skip, 0, "gelu", act_first)
    ref = _composed_gelu(src, bias, skip, act_first)
    assert got.shape == ref.shape == (2, c, 6, 5)
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(_bits(epilogue.bias_act(src, bias, skip, 0, "gelu", act_first)),
                       _bits(ref))


@pytest.mark.parametrize("c", [6, 12, 24, 78, 156, 312])
def test_flat_mode_serves_any_width_without_an_upsample(c):
    assert epilogue.serves(c, 640 * 96 * 72 * c)
    assert epilogue.serves(c, 3 * c) == (c % 8 == 0)
    assert epilogue.serves(c, 640 * c, up=1) == (c % 8 == 0)
    # the kernel's bias channels: vector v's k-th element is channel
    # (8 (v % pv) + k) % C, pv = C / gcd(C, 8), and its grid stride, a
    # multiple of pv, keeps them a thread's through the loop
    pv = c // np.gcd(c, 8)
    v = np.arange(4 * pv * 8)[:, None]
    k = np.arange(8)[None, :]
    assert (((8 * (v % pv) + k) % c) == ((8 * v + k) % c)).all()
    x = torch.zeros(2, c, 6, 5).contiguous(memory_format=torch.channels_last)
    conv = tl.Conv2d(c, c, 1, bias=True)
    with torch.no_grad():
        assert tl.conv_out(conv, None, x, any_width=True).fused
        assert tl.conv_out(conv, None, x).fused == (c % 8 == 0)
        assert tl.tensor_out(x, any_width=True).fused


# -- served forwards against the composed ones ---------------------------------

def _folded(dtype=torch.bfloat16, seed=0):
    """Tiny BN-folded HRNet and YOLOv3 with nonzero biases."""
    gen = torch.Generator().manual_seed(seed)
    hr = tl.fold_batchnorm(th.hrnet_init(th.tiny_test_config(), gen), dtype=dtype)
    yo = tl.fold_batchnorm(ty.yolov3_init(ty.tiny_yolo_test_config(), gen), dtype=dtype)
    with torch.no_grad():
        for m in list(hr.modules()) + list(yo.modules()):
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=gen)
    return hr, yo


def _int8(hr, yo):
    hq = tq.quantize_convs(hr, tq.uncalibrated_scales(hr, tq.hrnet_skip_ids(hr)))
    yq = tq.quantize_convs(yo, tq.uncalibrated_scales(
        yo, tq.yolo_skip_ids(yo, ty.tiny_yolo_test_config())))
    return hq, yq


def _resident(hq):
    import dataclasses

    hq.cfg = dataclasses.replace(hq.cfg, int8_resident=True)
    return hq


def _inputs(seed=1):
    gen = torch.Generator().manual_seed(seed)
    crops = torch.randn(3, 96, 64, 3, generator=gen).permute(0, 3, 1, 2)
    images = torch.rand(2, 64, 64, 3, generator=gen).permute(0, 3, 1, 2)
    return crops, images  # channels-last views, as the pipeline serves them


def _served_models(variant):
    hr, yo = _folded()
    if variant == "float":
        models = {"hrnet": hr, "yolov3": yo}
    elif variant == "packed":
        models = {"hrnet": pack_hrnet_branch0(hr)}
    elif variant == "int8":
        hq, yq = _int8(hr, yo)
        models = {"hrnet": hq, "yolov3": yq}
    else:
        models = {"hrnet": _resident(_int8(hr, yo)[0])}
    return {k: tl.to_channels_last(m) for k, m in models.items()}


def _forward(models, dtype=torch.bfloat16):
    crops, images = _inputs()
    out = []
    if "hrnet" in models:
        out.append(models["hrnet"](crops, dtype))
    if "yolov3" in models:
        out += models["yolov3"](images, dtype)
    return out


@pytest.mark.parametrize("variant", ["float", "packed", "int8", "int8_resident"])
def test_served_forward_equals_the_composed_forward(variant, monkeypatch):
    models = _served_models(variant)
    with torch.inference_mode(), counted(monkeypatch) as count:
        got = _forward(models)
    assert count["calls"] > 0
    with torch.inference_mode(), composed(monkeypatch):
        ref = _forward(models)
    for g, r in zip(got, ref, strict=True):
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(g, r)


def _convs(model, channels=epilogue.CHANNELS):
    return sum(1 for m in model.modules()
               if type(m) is tl.Conv2d and m.out_channels % channels == 0)


def _fuse_branch_terms(model):
    """Fuse rows whose own branch joins a running sum: rows 1.. of each
    module."""
    return sum(len(m.fuse_layers) - 1 for m in model.modules()
               if isinstance(m, th.HighResolutionModule))


def engaged_sites(name, model):
    """Epilogue launches one served forward of a BN-folded float model
    makes where convs leave their bias to it (the card): one per conv of 8k
    output channels, and HRNet's fuse rows add their own branch in one
    more."""
    return _convs(model) + (_fuse_branch_terms(model) if name == "hrnet" else 0)


def test_one_epilogue_an_engaged_call_site(monkeypatch):
    models = _served_models("float")
    assert {name: engaged_sites(name, m) for name, m in models.items()} == {
        "hrnet": 40 + 3, "yolov3": 66}
    for name, model in models.items():
        with torch.inference_mode(), counted(monkeypatch, bias_in_epilogue=True) as count:
            _forward({name: model})
        assert count["calls"] == engaged_sites(name, model), name


def test_bias_in_the_epilogue_stays_within_rounding(monkeypatch):
    hr, yo = _folded(torch.float32)
    models = {"hrnet": tl.to_channels_last(hr), "yolov3": tl.to_channels_last(yo)}
    with torch.inference_mode(), counted(monkeypatch, bias_in_epilogue=True):
        got = _forward(models, torch.float32)
    with torch.inference_mode(), composed(monkeypatch):
        ref = _forward(models, torch.float32)
    for g, r in zip(got, ref, strict=True):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def _grads(models, dtype):
    out = _forward(models, dtype)
    sum(o.float().square().mean() for o in out).backward()
    grads = {f"{k}.{n}": p.grad.clone() for k, m in models.items()
             for n, p in m.named_parameters()}
    for m in models.values():
        m.zero_grad(set_to_none=True)
    return [o.detach() for o in out], grads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_keeps_the_composed_path(dtype, monkeypatch):
    hr, yo = _folded(dtype)
    models = {"hrnet": tl.to_channels_last(hr), "yolov3": tl.to_channels_last(yo)}
    with counted(monkeypatch, bias_in_epilogue=True) as count:
        out, grads = _grads(models, dtype)
    assert count["calls"] == 0
    with composed(monkeypatch):
        ref_out, ref_grads = _grads(models, dtype)
    for g, r in zip(out, ref_out, strict=True):
        assert torch.equal(g, r)
    assert grads.keys() == ref_grads.keys()
    for k in grads:
        assert torch.equal(grads[k], ref_grads[k]), k


def test_live_bn_and_nchw_keep_the_composed_path(monkeypatch):
    """A live BN keeps its conv's composed ops (only the fuse rows' own
    branches, no conv's output, still join their sums in one pass); an NCHW
    input keeps them all."""
    gen = torch.Generator().manual_seed(0)
    live = tl.to_channels_last(th.hrnet_init(th.tiny_test_config(), gen))
    hr, _ = _folded()
    crops, _ = _inputs()
    for model, x, calls in ((live, crops, _fuse_branch_terms(live)),
                            (hr, crops.contiguous(), 0)):
        with torch.inference_mode(), counted(monkeypatch, bias_in_epilogue=True) as count:
            got = model(x)
        assert count["calls"] == calls
        with torch.inference_mode(), composed(monkeypatch):
            assert torch.equal(got, model(x))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: (output shape, up, bias, skip, act, act_first) of the main path's shapes:
#: HRNet-W48 branch 0 at 640 crops (a block's last conv), its stage-4 fuse
#: row 0 reading branch 3 upsampled 8x, and YOLOv3-416's 52x52 shortcut.
CARD_SHAPES = [
    ((640, 48, 96, 72), 0, True, True, "relu", False),
    ((640, 48, 96, 72), 3, True, True, "relu", False),
    ((160, 256, 52, 52), 0, True, True, "leaky", True),
]


@pytest.mark.card
def test_kernel_equals_plain(card):
    gen = torch.Generator().manual_seed(0)
    before = epilogue.launches
    for dtype, with_bias, skip_mode, act, up in MODES:
        src, bias, skip = (None if t is None else t.to(card)
                           for t in _operands(dtype, with_bias, skip_mode, up, gen))
        act_first = skip_mode == "before"
        got = epilogue.bias_act_cuda(src, bias, skip, up, act, act_first)
        ref = epilogue.bias_act_plain(src, bias, skip, up, act, act_first)
        assert torch.equal(_bits(got), _bits(ref)), (dtype, with_bias, skip_mode, act, up)
    gen = torch.Generator(device=card).manual_seed(0)
    for shape, up, with_bias, with_skip, act, act_first in CARD_SHAPES:
        n, c, h, w = shape
        mk = dict(generator=gen, device=card)
        src = torch.randn((n, c, h >> up, w >> up), **mk).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bias = torch.randn(c, **mk).to(torch.bfloat16) if with_bias else None
        skip = (torch.randn(shape, **mk).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) if with_skip else None)
        got = epilogue.bias_act_cuda(src, bias, skip, up, act, act_first)
        ref = epilogue.bias_act_plain(src, bias, skip, up, act, act_first)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ref)), shape
        del src, skip, got, ref
    assert epilogue.launches - before == len(MODES) + len(CARD_SHAPES)


#: HRFormer-B's FFN and fuse at branch 0 (and 1) of 640 crops: fc1's and
#: dw3x3's bias + GELU (312 wide), fc2's bias + GELU + residual (78 and 156
#: wide, the flat mode), a fuse row's sum and ReLU (78 wide).
GELU_CARD_SHAPES = [
    ((640, 312, 96, 72), True, False, "gelu", False),
    ((640, 78, 96, 72), True, True, "gelu", True),
    ((640, 156, 48, 36), True, True, "gelu", True),
    ((640, 78, 96, 72), True, True, "relu", False),
]


@pytest.mark.card
def test_kernel_gelu_and_flat_mode_equal_plain(card):
    """The GELU mode and the flat mode bit for bit against PyTorch's
    composed passes on the card, in every GELU mode at small shapes (24 and
    78 wide) and at HRFormer-B's branch-0 shapes."""
    gen = torch.Generator().manual_seed(0)
    before = epilogue.launches
    for dtype, with_bias, skip_mode, c in GELU_MODES:
        src, bias, skip = (None if t is None else t.to(card) for t in _operands(
            dtype, with_bias, skip_mode, 0, gen, shape=(2, c, 6, 5)))
        act_first = skip_mode == "before"
        got = epilogue.bias_act_cuda(src, bias, skip, 0, "gelu", act_first)
        ref = epilogue.bias_act_plain(src, bias, skip, 0, "gelu", act_first)
        assert torch.equal(_bits(got), _bits(ref)), (dtype, with_bias, skip_mode, c)
    gen = torch.Generator(device=card).manual_seed(0)
    for shape, with_bias, with_skip, act, act_first in GELU_CARD_SHAPES:
        mk = dict(generator=gen, device=card)
        src = (2 * torch.randn(shape, **mk)).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bias = torch.randn(shape[1], **mk).to(torch.bfloat16) if with_bias else None
        skip = (torch.randn(shape, **mk).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) if with_skip else None)
        got = epilogue.bias_act_cuda(src, bias, skip, 0, act, act_first)
        ref = epilogue.bias_act_plain(src, bias, skip, 0, act, act_first)
        torch.cuda.synchronize()
        ulps = (_bits(got).int() - _bits(ref).int()).abs().max()
        print(f"{shape} {act}: largest difference {int(ulps)} bf16 ulps")
        assert torch.equal(_bits(got), _bits(ref)), shape
        del src, skip, got, ref
    assert epilogue.launches - before == len(GELU_MODES) + len(GELU_CARD_SHAPES)


@pytest.mark.card
def test_full_width_stage_a_with_the_kernel_and_composed(card, monkeypatch):
    from tpupose_torch.data.synthetic import make_scene
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.pipeline import Pipeline
    from tpupose_torch.tracking.tracker import TrackerConfig

    gen = torch.Generator().manual_seed(0)
    det_cfg, pose_cfg = ty.YoloConfig(max_candidates=4), th.hrnet_w48_config()
    det = tl.fold_batchnorm(ty.yolov3_init(det_cfg, gen), dtype=torch.bfloat16)
    pose = tl.fold_batchnorm(th.hrnet_init(pose_cfg, gen), dtype=torch.bfloat16)
    with torch.no_grad():
        for m in list(det.modules()) + list(pose.modules()):
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=gen)
    views, frames = 2, 2
    scene = make_scene(num_frames=1, num_cameras=views, num_actors=2, seed=0)
    cams = make_camera_set(scene.P, scene.K, scene.RT, 320, 256)
    pipe = Pipeline(cams, TrackerConfig(num_cameras=views, max_dets=4), det_cfg, det,
                    pose_cfg, pose, device=card)
    clip = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, size=(frames, views, 256, 320, 3), dtype=np.uint8), device=card)
    crops = torch.randn(8, 384, 288, 3, generator=torch.Generator(device=card).manual_seed(1),
                        device=card).to(torch.bfloat16).permute(0, 3, 1, 2)
    images = torch.rand(frames * views, 416, 416, 3, device=card).permute(0, 3, 1, 2)

    def run():
        with torch.inference_mode():
            heat = pipe.pose_model(crops)
            heads = pipe.detector(images)
        return [heat, *heads, *pipe.process_clip_nn(clip)]

    before = epilogue.launches
    with torch.inference_mode():
        pipe.pose_model(crops)
    assert epilogue.launches - before == engaged_sites("hrnet", pipe.pose_model) == 292 + 15
    before = epilogue.launches
    with torch.inference_mode():
        pipe.detector(images)
    assert epilogue.launches - before == engaged_sites("yolov3", pipe.detector) == 72
    got = run()
    with composed(monkeypatch):
        before = epilogue.launches
        ref = run()
        assert epilogue.launches == before
    for g, r in zip(got, ref, strict=True):
        assert torch.equal(g, r)
