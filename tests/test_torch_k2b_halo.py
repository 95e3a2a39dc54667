"""K2b's halo path (`ops.int8_conv.halo_path`, `halo_tile`): which int8
convs take it, and that its patches cover each output pixel once.

* The route at every int8 conv shape of the main path's two networks
  (HRNet-W48 at 384 x 288, YOLOv3-416, and the width-packed branch 0): every
  3 x 3 stride-1 conv of HRNet's branches 0 and 1 and layer1 takes it; none
  of YOLOv3's, each for too few K steps or too little fill, the shapes
  where it measured slower; no 1 x 1, strided or dilated conv does; a
  taken conv's patches cover its output once. The tables below are the networks'
  (checked against a forward on meta tensors), and the launches they give a
  stage-A batch are `chip_smoke.py`'s `STEP_LAUNCHES`.
* On the card (marked `card`): K2b on the halo path `torch.equal` to the
  plain version at the main path's engaged shapes and at edge shapes, in
  every store mode. Run them there with
  `python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_k2b_halo.py`
  (this file imports no JAX). The emulation of the kernel's address
  arithmetic is `tests/test_torch_kernel_emulation.py`'s.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import tpupose_torch.ops.int8_conv as tk

ROOT = Path(__file__).resolve().parent.parent

#: (Cin, H, W, Cout, k, stride, dilation): convs a forward, as
#: `chip_smoke.main_path_conv_shapes` counts them.
HRNET = {
    (3, 384, 288, 64, 3, 2, 1): 1, (48, 24, 18, 384, 3, 2, 1): 2,
    (48, 48, 36, 48, 3, 2, 1): 2, (48, 48, 36, 192, 3, 2, 1): 6,
    (48, 96, 72, 48, 3, 1, 1): 64, (48, 96, 72, 48, 3, 2, 1): 8,
    (48, 96, 72, 96, 3, 2, 1): 7, (64, 96, 72, 64, 1, 1, 1): 1,
    (64, 96, 72, 64, 3, 1, 1): 4, (64, 96, 72, 256, 1, 1, 1): 5,
    (64, 192, 144, 64, 3, 2, 1): 1, (96, 24, 18, 384, 3, 2, 1): 2,
    (96, 48, 36, 48, 1, 1, 1): 8, (96, 48, 36, 96, 3, 1, 1): 64,
    (96, 48, 36, 96, 3, 2, 1): 2, (96, 48, 36, 192, 3, 2, 1): 7,
    (192, 24, 18, 48, 1, 1, 1): 7, (192, 24, 18, 96, 1, 1, 1): 6,
    (192, 24, 18, 192, 3, 1, 1): 56, (192, 24, 18, 384, 3, 2, 1): 3,
    (256, 96, 72, 48, 3, 1, 1): 1, (256, 96, 72, 64, 1, 1, 1): 3,
    (256, 96, 72, 96, 3, 2, 1): 1, (384, 12, 9, 48, 1, 1, 1): 3,
    (384, 12, 9, 96, 1, 1, 1): 2, (384, 12, 9, 192, 1, 1, 1): 2,
    (384, 12, 9, 384, 3, 1, 1): 24}
YOLO = {
    (3, 416, 416, 32, 3, 1, 1): 1, (32, 208, 208, 64, 3, 1, 1): 1,
    (32, 416, 416, 64, 3, 2, 1): 1, (64, 104, 104, 128, 3, 1, 1): 2,
    (64, 208, 208, 32, 1, 1, 1): 1, (64, 208, 208, 128, 3, 2, 1): 1,
    (128, 52, 52, 256, 3, 1, 1): 11, (128, 104, 104, 64, 1, 1, 1): 2,
    (128, 104, 104, 256, 3, 2, 1): 1, (256, 26, 26, 128, 1, 1, 1): 1,
    (256, 26, 26, 512, 3, 1, 1): 11, (256, 52, 52, 128, 1, 1, 1): 10,
    (256, 52, 52, 512, 3, 2, 1): 1, (384, 52, 52, 128, 1, 1, 1): 1,
    (512, 13, 13, 256, 1, 1, 1): 1, (512, 13, 13, 1024, 3, 1, 1): 7,
    (512, 26, 26, 256, 1, 1, 1): 10, (512, 26, 26, 1024, 3, 2, 1): 1,
    (768, 26, 26, 256, 1, 1, 1): 1, (1024, 13, 13, 512, 1, 1, 1): 7}
#: HRNet-W48's branch 0 width-packed (`ops.packing`): 96 -> 96 at 96 x 36
PACKED_BRANCH0 = (96, 96, 36, 96, 3, 1, 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _covers_once(h, w):
    """Each of the H x W output pixels is one patch row of exactly one
    patch, and a patch has at most GEMM_ROWS rows."""
    th, tw = tk.halo_tile(h, w)
    assert 1 <= th <= h and 1 <= tw <= w and th * tw <= tk.GEMM_ROWS
    hits = np.zeros((h, w), dtype=np.int64)
    rows = np.arange(th * tw)
    for oy0 in range(0, h, th):
        for ox0 in range(0, w, tw):
            oy, ox = oy0 + rows // tw, ox0 + rows % tw
            inside = (oy < h) & (ox < w)
            np.add.at(hits, (oy[inside], ox[inside]), 1)
    assert (hits == 1).all()


@pytest.mark.parametrize("net,shape", [("hrnet", sh) for sh in HRNET]
                         + [("yolo", sh) for sh in YOLO] + [("hrnet", PACKED_BRANCH0)])
def test_route_at_main_path_shapes(net, shape):
    cin, h, w, _, k, stride, dil = shape
    engaged = tk.halo_path(cin, k, k, stride, dil, h, w)
    if k != 3 or stride != 1 or dil != 1 or not tk.channels_last(cin):
        assert not engaged
    # HRNet's branches 0 and 1 (and packed branch 0) and layer1
    elif net == "hrnet" and cin <= 96:
        assert engaged
    # YOLOv3's: 32 -> 64 at 208 x 208 has 5 K steps, the rest fill too little
    elif net == "yolo":
        assert not engaged
        steps = -(-9 * cin // 64)
        assert (steps < tk.HALO_MIN_STEPS) == (cin == 32)
        assert steps < tk.HALO_MIN_STEPS or tk.halo_fill(h, w) < tk.HALO_MIN_FILL
    if engaged:
        _covers_once(h, w)
        assert tk.halo_fill(h, w) >= tk.HALO_MIN_FILL
        assert tk.halo_smem(cin, *tk.halo_tile(h, w)) <= tk.HALO_SMEM_LIMIT


def test_halo_launches_of_a_stage_a_batch():
    """A stage-A batch runs each network's forward once: 132 of HRNet-W48's
    and none of YOLOv3-416's K2b launches take the halo path, packed branch
    0 or not, as `chip_smoke.py` holds them; the tables are the networks'."""
    cs = _chip_smoke()
    assert cs.main_path_conv_shapes(torch) == (HRNET, YOLO)
    counts = [sum(n for (cin, h, w, _, k, st, dil), n in table.items()
                  if tk.halo_path(cin, k, k, st, dil, h, w)) for table in (HRNET, YOLO)]
    assert counts == [132, 0]
    packed = {**HRNET, PACKED_BRANCH0: HRNET[(48, 96, 72, 48, 3, 1, 1)]}
    del packed[(48, 96, 72, 48, 3, 1, 1)]
    assert sum(n for (cin, h, w, _, k, st, dil), n in packed.items()
               if tk.halo_path(cin, k, k, st, dil, h, w)) == 132
    assert cs.STEP_LAUNCHES["int8"]["int8_conv.halo_launches"] == sum(counts)
    assert cs.STEP_LAUNCHES["bf16"]["int8_conv.halo_launches"] == 0


@pytest.mark.parametrize("hw", [(96, 72), (48, 36), (24, 18), (12, 9), (208, 208), (104, 104),
                                (52, 52), (26, 26), (13, 13), (96, 36), (1, 1), (5, 3),
                                (37, 23), (130, 7), (3, 300)])
def test_halo_tile_covers_each_pixel_once(hw):
    _covers_once(*hw)


def test_halo_tile_at_the_main_path():
    assert tk.halo_tile(96, 72) == (16, 8)  # branch 0: 54 patches, no row wasted
    assert tk.halo_tile(48, 36) == (7, 18)  # branch 1: 14 patches of 126 pixels
    assert tk.halo_fill(96, 72) == 1.0 and tk.halo_fill(24, 18) < tk.HALO_MIN_FILL
    # an odd number of chunks a pixel, a row pitch equal to tw pixels' mod 8
    for cin in (16, 32, 48, 64, 96, 128, 256, 512):
        for tw in (4, 8, 9, 13, 16, 18):
            pixel, row = tk.halo_layout(cin, tw)
            assert pixel % 2 == 1 and pixel >= cin // 16 and row >= (tw + 2) * pixel
            assert (row - tw * pixel) % 8 == 0


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: (Cin, H, W, Cout, batch): the main path's engaged shapes at a few images,
#: Cin 16, an image smaller than a patch, H and W no patch divides, a Cout
#: past one channel tile that is no multiple of 16
CARD_SHAPES = [(48, 96, 72, 48, 3), (96, 48, 36, 96, 2), (64, 96, 72, 64, 2), (96, 96, 36, 96, 2),
               (32, 208, 208, 64, 1), (64, 104, 104, 128, 1), (128, 52, 52, 256, 2),
               (16, 20, 30, 24, 3), (32, 5, 3, 40, 3), (48, 37, 23, 80, 2), (16, 1, 1, 16, 2)]


@pytest.mark.card
@pytest.mark.parametrize("cin,h,w,cout,batch", CARD_SHAPES)
def test_halo_kernel_equals_plain(card, cin, h, w, cout, batch):
    """Every store mode on an int8 channels-last input (K2b alone): NHWC and
    NCHW, f32, bf16 and int8 requant-relu outputs, the requantizing mode
    through bf16 and f32; each a launch on the halo path, `torch.equal` to
    the plain version. Where `halo_path` declines a shape, the kernel is
    still driven on it (the wrapper's rule forced), since the C entry takes
    any patch."""
    gen = torch.Generator(device=card).manual_seed(cin + h + w)
    mk = dict(generator=gen, device=card)
    wq = torch.randint(-127, 128, (cout, cin, 3, 3), dtype=torch.int32, **mk).to(torch.int8)
    x = torch.randint(-127, 128, (batch, h, w, cin), dtype=torch.int32, **mk).to(torch.int8)
    xc = x.permute(0, 3, 1, 2)  # the channels-last int8 activation K2b reads in place
    acc_std = 73.3 * 73.3 * (9 * cin) ** 0.5
    wk = tk.pack_weight(wq)
    inv_next = torch.tensor([127.0 / 4.0], device=card)
    rule = tk.halo_path
    tk.halo_path = lambda *a: True
    try:
        for out_dtype, nhwc, requant in [
                (torch.bfloat16, True, None), (torch.float32, False, None),
                (torch.bfloat16, False, None), (torch.int8, False, None),
                (torch.float32, True, None), (torch.int8, True, (torch.bfloat16, "relu")),
                (torch.int8, True, (torch.float32, "leaky"))]:
            gain = 20.0 if out_dtype == torch.int8 else 1.0
            mul = (torch.rand((cout,), **mk) + 0.5) * (gain / acc_std)
            add = torch.randn((cout,), **mk) * gain
            before = tk.halo_launches
            got = tk.gemm_nhwc_cuda(x, wk, (3, 3), mul, add, out_dtype, nhwc_out=nhwc,
                                    requant=None if requant is None else (*requant, inv_next))
            assert tk.halo_launches == before + 1
            if requant is None:
                ref = tk.int8_conv_plain(xc, wq, None, mul, add, out_dtype)
            else:
                ref = tk.int8_conv_requant_plain(xc, wq, None, mul, add, *requant, inv_next)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (out_dtype, nhwc, requant)
    finally:
        tk.halo_path = rule
