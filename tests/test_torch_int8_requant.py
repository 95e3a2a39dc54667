"""K2b's requantizing mode: where one int8 conv's activated output is read
by one other int8 conv alone, the first conv's epilogue writes the second
one's int8 input (`ops.int8_conv.int8_conv_requant`, `models.layers.
chain_out` / `requantizes`).

* The plain version is today's three steps composed (the dequantize store to
  bf16 or f32, the activation-only pass of `ops.epilogue`, the next conv's
  `quantize_input`), and it equals, `torch.equal`, an element-by-element
  f32 emulation of the kernel's epilogue formula (`csrc/int8_conv.cu`
  `requant`), with NaN and infinities planted in `mul` / `add`, codes at
  and past +-127, ragged Cout, 1x1 and 3x3 at strides 1 and 2.
* The networks: tiny int8 HRNets (unpacked, width-packed branch 0, and one
  of 16k widths where every chain engages) and a tiny int8 YOLOv3, served
  (inference mode, channels-last), give `torch.equal` outputs with the rule
  engaged and forced off; the engaged forward makes one requantizing call
  per structural pair whose Cin takes K2b's route, and that many fewer K2a
  passes and epilogue passes. HRNet-W48 and YOLOv3-416 have 124 and 35 such
  pairs (`chip_smoke.py` `STEP_LAUNCHES`).
* The rule declines under autograd, on an NCHW input, with a live BN, for a
  QAT conv and where a Cin is no multiple of 16.
* On the card (marked `card`): the kernel bit for bit against the plain
  version at the main path's shapes (HRNet-W48 branch 0's 3x3 48->48 at
  96x72 x 640, the stage-1 1x1 256->64, YOLOv3-416's 1x1 128->64 at 52x52 x
  160 with leaky ReLU), and in every mode at small shapes. Run them there
  with
  `python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_int8_requant.py`
  (this file imports no JAX).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import tpupose_torch.models.hrnet as th
import tpupose_torch.models.layers as tl
import tpupose_torch.models.quantize as tq
import tpupose_torch.models.yolov3 as ty
import tpupose_torch.ops.int8_conv as tk
from tpupose_torch.ops import epilogue
from tpupose_torch.ops.packing import pack_hrnet_branch0

torch.set_num_threads(1)

CL = torch.channels_last


# -- the plain version against the three steps and the kernel's formula ----------

def _bf16(v):
    """f32 -> bf16 -> f32, round to nearest even (a NaN stays a NaN)."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    out = r.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(v), v, out).astype(np.float32)


def _kernel_formula(acc, mul, add, mid_dtype, act, inv_next):
    """`requant` of csrc/int8_conv.cu in numpy f32, one element at a time:
    float(acc) * mul, + add, rounded to the intermediate's type, the
    activation (ReLU as fmaxf, a NaN to 0), then `quantize_sat` at inv_next
    (a NaN to 0, else round half to even and clamp). acc (N, C, H, W)
    int32."""
    f32 = np.float32
    mid = _bf16 if mid_dtype == torch.bfloat16 else (lambda t: t)
    a = acc.numpy().astype(f32)
    v = (a * mul.numpy()[:, None, None]).astype(f32)
    if add is not None:
        v = (v + add.numpy()[:, None, None]).astype(f32)
    v = mid(v)
    with np.errstate(invalid="ignore"):
        if act == "relu":
            v = np.fmax(v, f32(0))
        elif act == "leaky":
            v = np.where(v > 0, v, mid((v * f32(0.1)).astype(f32)))
        p = (v * f32(inv_next.item())).astype(f32)
        q = np.where(np.isnan(p), f32(0), np.clip(np.rint(p), -127, 127))
    return torch.as_tensor(q.astype(np.int8))


#: (cin, cout, k, stride) of the plain cases: 1x1 and 3x3 at strides 1 and 2,
#: Cout 48 and 96 (ragged against K2b's 64-wide tiles).
PLAIN_CASES = [(16, 48, 1, 1), (32, 96, 1, 2), (48, 48, 3, 1), (16, 96, 3, 2)]


def _requant_operands(rng, cin, cout, k, in_dtype, act):
    """Weights, a channels-last input, 1 / x_scale, the dequantize vectors
    with a NaN and infinities planted, and inv_next, scaled so that the
    activated values quantize past both ends of [-127, 127]."""
    wq = torch.as_tensor(rng.integers(-127, 128, size=(cout, cin, k, k)).astype(np.int8))
    shape = (2, cin, 9, 7)
    if in_dtype == torch.int8:
        x = torch.as_tensor(rng.integers(-127, 128, size=shape).astype(np.int8))
        code_std = 73.3
    else:
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 3).to(in_dtype)
        x[0, 0, 1, 2] = float("nan")
        code_std = 3 * 127 / 6.0
    inv = torch.tensor([127.0 / 6.0])
    acc_std = code_std * 73.3 * (cin * k * k) ** 0.5
    # dequantized values ~N(0, 20): x 127/4 they pass 127 (and -127 through
    # leaky ReLU's tenth)
    mul = torch.as_tensor(rng.uniform(0.5, 1.5, cout).astype(np.float32)) * (20.0 / acc_std)
    add = torch.as_tensor(rng.standard_normal(cout).astype(np.float32))
    mul[0], mul[1], add[2], add[3] = float("nan"), float("inf"), -float("inf"), float("nan")
    return wq, x.contiguous(memory_format=CL), inv, mul, add, torch.tensor([127.0 / 4.0])


@pytest.mark.parametrize("mid_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["relu", "leaky"])
@pytest.mark.parametrize("case", PLAIN_CASES)
def test_plain_is_the_three_steps_and_the_kernel_formula(case, act, mid_dtype):
    cin, cout, k, stride = case
    rng = np.random.default_rng(cin + cout + k + stride)
    in_dtype = torch.int8 if stride == 2 else mid_dtype
    wq, x, inv, mul, add, inv_next = _requant_operands(rng, cin, cout, k, in_dtype, act)
    got = tk.int8_conv_requant_plain(x, wq, inv, mul, add, mid_dtype, act, inv_next, stride)
    y = tk.int8_conv_plain(x, wq, inv, mul, add, mid_dtype, stride)
    steps = tk.quantize_input(epilogue.bias_act_plain(y, act=act), inv_next)
    assert got.dtype == torch.int8 and got.is_contiguous(memory_format=CL)
    assert torch.equal(got, steps)
    xq = x if in_dtype == torch.int8 else tk.quantize_input(x, inv)
    acc = tk.conv_exact(xq, wq, stride).contiguous()
    assert torch.equal(got, _kernel_formula(acc, mul, add, mid_dtype, act, inv_next))
    # the models' dispatch takes the plain version on the CPU
    assert torch.equal(tk.int8_conv_requant(x, wq, None, inv, mul, add, mid_dtype, act,
                                            inv_next, stride), got)
    # the planted channels: NaN quantizes to 0, +inf to 127, -inf through
    # ReLU to 0 and through leaky ReLU to -127
    assert not got[:, 0].any() and not got[:, 3].any()
    assert (got[:, 2] == (0 if act == "relu" else -127)).all()
    assert got[:, 1].max() == 127
    # both clamps are reached by finite values, and passed
    finite = got[:, 4:]
    assert finite.max() == 127 and finite.min() == (0 if act == "relu" else -127)
    pre = torch.as_tensor(epilogue.bias_act_plain(y, act=act).float()[:, 4:] * inv_next)
    assert pre.max() > 128 and (act == "relu" or pre.min() < -128)


def test_requant_cuda_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    wq, x, inv, mul, add, inv_next = _requant_operands(rng, 16, 48, 1, torch.float32, "relu")
    with pytest.raises(ValueError, match="CUDA"):
        tk.int8_conv_requant_cuda(x, tk.pack_weight(wq), (1, 1), inv, mul, add,
                                  torch.float32, "relu", inv_next)


# -- the networks: engaged against forced off --------------------------------

def _pairs(model):
    """The (conv, bn, next conv, next bn) pairs of `model` in which the first
    conv's activated output is read by the next alone: HRNet's basic-block
    conv1 -> conv2, the bottlenecks' conv1 -> conv2 -> conv3 and the steps
    of each fuse row's stride-2 chain; YOLOv3's residual 1x1 -> 3x3 and the
    runs of its three conv sets."""
    out = []
    if isinstance(model, th.HRNet):
        for m in model.modules():
            if isinstance(m, th.BasicBlock):
                out.append((m.conv1, m.bn1, m.conv2, m.bn2))
            elif isinstance(m, th.Bottleneck):
                out += [(m.conv1, m.bn1, m.conv2, m.bn2), (m.conv2, m.bn2, m.conv3, m.bn3)]
            elif isinstance(m, th.HighResolutionModule):
                for i, row in enumerate(m.fuse_layers):
                    for j in range(i):
                        chain = row[j]
                        out += [(a[0], a[1], b[0], b[1]) for a, b in zip(chain, chain[1:])]
        return out
    blocks = [getattr(model, f"conv{i}") for i in range(len(model.specs))]
    # the residual blocks after each stride-2 conv (1, 4, 9, 26, 43), then
    # the conv sets
    residual = [(i, i + 1) for first, n in ((2, 1), (5, 2), (10, 8), (27, 8), (44, 4))
                for i in range(first, first + 2 * n, 2)]
    runs = residual + [(52, 56), (60, 64), (68, 72)]
    for first, last in runs:
        out += [(blocks[i].conv, blocks[i].bn, blocks[i + 1].conv, blocks[i + 1].bn)
                for i in range(first, last)]
    return out


def _cin(conv):
    return conv.weight_q.shape[1] if isinstance(conv, tl.QuantConv2d) else conv.in_channels


def structural_count(model):
    """The pairs in which both convs' Cin take K2b's route: the requantizing
    calls one served int8 forward makes."""
    return sum(1 for c, _, n, _ in _pairs(model)
               if tk.channels_last(_cin(c)) and tk.channels_last(_cin(n)))


def test_main_path_pair_counts():
    """HRNet-W48: 104 basic blocks, 4 bottlenecks (2 pairs each) and 12 fuse
    chain steps; YOLOv3-416: 23 residual blocks and 3 x 4 conv-set steps;
    every Cin a multiple of 16."""
    with torch.device("meta"):
        hr = th.HRNet(th.hrnet_w48_config())
        yo = ty.YOLOv3(ty.YoloConfig())
    assert (len(_pairs(hr)), structural_count(hr)) == (124, 124)
    assert (len(_pairs(yo)), structural_count(yo)) == (35, 35)


def _w16_config():
    """A tiny HRNet whose every width is a multiple of 16: every pair
    engages, the bottleneck's included (conv2 requantizes its int8 input
    into conv3's)."""
    return dataclasses.replace(th.tiny_test_config(), width=16, layer1_planes=16)


def _inputs(seed=1):
    gen = torch.Generator().manual_seed(seed)
    crops = torch.randn(3, 96, 64, 3, generator=gen).permute(0, 3, 1, 2)
    images = torch.rand(2, 64, 64, 3, generator=gen).permute(0, 3, 1, 2)
    return crops, images  # channels-last views, as the pipeline serves them


def _int8_model(variant, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    crops, images = _inputs(seed + 7)
    if variant == "yolov3":
        cfg = ty.tiny_yolo_test_config()
        folded = tl.fold_batchnorm(ty.yolov3_init(cfg, gen), dtype=dtype)
        model = tq.quantize_yolo(folded, cfg, images, dtype)
    else:
        cfg = _w16_config() if variant == "hrnet_w16" else th.tiny_test_config()
        folded = tl.fold_batchnorm(th.hrnet_init(cfg, gen), dtype=dtype)
        model = tq.quantize_hrnet(folded, cfg, crops, compute_dtype=dtype)
        if variant == "hrnet_packed":
            model = pack_hrnet_branch0(model)
    return tl.to_channels_last(model)


@contextlib.contextmanager
def counted(monkeypatch, engaged=True):
    """Counts what the card would launch (the plain versions run): the
    requantizing calls, K2a (a conv of a float channels-last input whose Cin
    takes K2b's route), every conv, and the epilogue's passes; with
    `engaged=False` the rule is forced off."""
    count = {"requant": 0, "k2a": 0, "convs": 0, "epilogue": 0}
    conv, requant, bias_act = tl.int8_conv, tl.int8_conv_requant, epilogue.bias_act

    def k2a(x):
        count["k2a"] += (x.dtype != torch.int8 and tk.channels_last(x.shape[1])
                         and x.is_contiguous(memory_format=CL))

    def counted_conv(x, *args):
        k2a(x)
        count["convs"] += 1
        return conv(x, *args)

    def counted_requant(x, *args):
        k2a(x)
        count["convs"] += 1
        count["requant"] += 1
        return requant(x, *args)

    def counted_bias_act(src, *args):
        out = bias_act(src, *args)
        count["epilogue"] += out is not src
        return out

    with monkeypatch.context() as m:
        m.setattr(tl, "int8_conv", counted_conv)
        m.setattr(tl, "int8_conv_requant", counted_requant)
        m.setattr(epilogue, "bias_act", counted_bias_act)
        if not engaged:
            m.setattr(tl, "requantizes", lambda *args: False)
        yield count


def _forward(model, dtype):
    crops, images = _inputs()
    with torch.inference_mode():
        out = model(images if isinstance(model, ty.YOLOv3) else crops, dtype)
    return out if isinstance(out, list) else [out]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["hrnet", "hrnet_packed", "hrnet_w16", "yolov3"])
def test_engaged_equals_forced_off(variant, dtype, monkeypatch):
    model = _int8_model(variant, dtype)
    with counted(monkeypatch) as on:
        got = _forward(model, dtype)
    with counted(monkeypatch, engaged=False) as off:
        ref = _forward(model, dtype)
    for g, r in zip(got, ref, strict=True):
        assert g.is_contiguous(memory_format=CL)
        assert torch.equal(g, r)
    n = structural_count(model)
    assert n > 0 and off["requant"] == 0
    if variant == "hrnet_w16":
        # basic blocks of stages 2-4, the bottleneck's two pairs, one fuse step
        assert n == len(_pairs(model)) == 2 + 3 + 4 + 2 + 1
    assert on["requant"] == n
    assert (on["k2a"], on["epilogue"], on["convs"]) == (off["k2a"] - n, off["epilogue"] - n,
                                                        off["convs"])


def _chain_args(cin=16, mid=16, fake=False, live_bn=False):
    gen = torch.Generator().manual_seed(3)
    a, b = tl.Conv2d(cin, mid, 3), tl.Conv2d(mid, 16, 1)
    for c in (a, b):
        c.weight.data.normal_(0.0, 0.2, generator=gen)
    bn = tl.BatchNorm2d(mid) if live_bn else None
    if fake:
        return (tl.FakeQuantConv2d.from_conv(a, 0.05), bn), (b, None)
    return (tq._quantize_conv(a, 2.0), bn), (tq._quantize_conv(b, 2.0), None)


DECLINES = {  # name: (chain arguments, grad on, NCHW input)
    "autograd": ({}, True, False),
    "nchw_input": ({}, False, True),
    "live_bn": ({"live_bn": True}, False, False),
    "qat_conv": ({"fake": True}, False, False),
    "cin_8": ({"cin": 8}, False, False),
    "next_cin_8": ({"mid": 8}, False, False),
}


@pytest.mark.parametrize("name", sorted(DECLINES))
def test_the_rule_declines(name, monkeypatch):
    kwargs, grad, nchw = DECLINES[name]
    first, second = _chain_args(**kwargs)
    x = torch.randn(2, kwargs.get("cin", 16), 6, 5, generator=torch.Generator().manual_seed(4))
    x = x if nchw else x.contiguous(memory_format=CL)
    with torch.set_grad_enabled(grad):
        assert not tl.requantizes(*first, *second, x)
        with counted(monkeypatch) as count:
            got = tl.finish(tl.chain_out(x, first, second, act="relu"))
        with counted(monkeypatch, engaged=False):
            ref = tl.finish(tl.chain_out(x, first, second, act="relu"))
    assert count["requant"] == 0
    assert torch.equal(got, ref)
    if name in ("autograd", "nchw_input"):  # the same convs engage where served
        with torch.inference_mode():
            assert tl.requantizes(*first, *second, x.contiguous(memory_format=CL))


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_operands(gen, shape, batch, in_dtype, act):
    """Operands of one conv of `shape` (cin, h, w, cout, k, stride) at
    `batch` on the card, scaled as `_requant_operands` scales them."""
    cin, h, w, cout, k, _ = shape
    mk = dict(generator=gen, device="cuda")
    wq = torch.randint(-127, 128, (cout, cin, k, k), dtype=torch.int32, **mk).to(torch.int8)
    if in_dtype == torch.int8:
        x = torch.randint(-127, 128, (batch, cin, h, w), dtype=torch.int32, **mk).to(torch.int8)
        code_std = 73.3
    else:
        x = (torch.randn((batch, cin, h, w), **mk) * 3).to(in_dtype)
        x[0, 0, h // 2, w // 2] = x[-1, -1, h // 3, w // 3] = float("nan")
        code_std = 3 * 127 / 6.0
    inv = torch.tensor([127.0 / 6.0], device="cuda")
    acc_std = code_std * 73.3 * (cin * k * k) ** 0.5
    mul = (torch.rand((cout,), **mk) + 0.5) * (20.0 / acc_std)
    add = torch.randn((cout,), **mk)
    mul[0], mul[1], add[2], add[3] = float("nan"), float("inf"), -float("inf"), float("nan")
    x = x.contiguous(memory_format=CL)
    return wq, x, inv, mul, add, torch.tensor([127.0 / 4.0], device="cuda")


def _held(wq, x, inv, mul, add, mid, act, inv_next, stride, parts):
    """The kernel's codes on the whole batch against the plain version on
    `parts` of it (slices of images)."""
    k = wq.shape[2]
    before = (tk.requant_launches, tk.launches)
    got = tk.int8_conv_requant_cuda(x, tk.pack_weight(wq), (k, k), inv, mul, add, mid, act,
                                    inv_next, stride)
    assert (tk.requant_launches - before[0], tk.launches - before[1]) == (1, 1)
    assert got.dtype == torch.int8 and got.is_contiguous(memory_format=CL)
    for part in parts:
        ref = tk.int8_conv_requant_plain(x[part], wq, inv, mul, add, mid, act, inv_next,
                                         stride)
        torch.cuda.synchronize()
        assert torch.equal(got[part], ref), (tuple(x.shape), mid, act, part)
    return got


@pytest.mark.card
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_kernel_equals_plain_small(card, in_dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    for cin, cout, k, stride in PLAIN_CASES + [(64, 16, 3, 1), (16, 72, 3, 1)]:
        for mid in (torch.bfloat16, torch.float32):
            for act in (None, "relu", "leaky"):
                ops = _card_operands(gen, (cin, 11, 13, cout, k, stride), 3, in_dtype, act)
                _held(*ops[:5], mid, act, ops[5], stride, [slice(0, 3)])


#: (name, (cin, h, w, cout, k, stride), batch, act) at the main path's shapes
MAIN_SHAPES = [
    ("hrnet_branch0_3x3_48", (48, 96, 72, 48, 3, 1), 640, "relu"),
    ("hrnet_stage1_1x1_256_64", (256, 96, 72, 64, 1, 1), 640, "relu"),
    ("yolo_1x1_128_64", (128, 52, 52, 64, 1, 1), 160, "leaky"),
]


@pytest.mark.card
@pytest.mark.parametrize("name,shape,batch,act", MAIN_SHAPES)
def test_kernel_equals_plain_main_path(card, name, shape, batch, act):
    """The whole batch through the kernel, its first and last 8 crops (4
    images) held to the plain version, on a bf16 input (K2a first) and on
    an int8 one (K2b alone)."""
    gen = torch.Generator(device=card).manual_seed(1)
    sub = 8 if batch == 640 else 4
    parts = [slice(0, sub), slice(batch - sub, batch)]
    for in_dtype in (torch.bfloat16, torch.int8):
        ops = _card_operands(gen, shape, batch, in_dtype, act)
        got = _held(*ops[:5], torch.bfloat16, act, ops[5], shape[5], parts)
        assert got.max() == 127 and got.min() == (0 if act == "relu" else -127), name
        del ops, got
