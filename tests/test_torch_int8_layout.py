"""The channels-last int8 conv path's layouts (kernels K2a and K2b of
`tpupose_torch/csrc/int8_conv.cu`) on the CPU.

K2a quantizes an NCHW activation once into an (N, H, W, Cp) int8 copy,
Cp = Cin rounded up to 16; its plain version is
`ops.int8_conv.quantize_nhwc_plain`. K2b is an implicit GEMM over that
copy with K in (r, c, ci) order, against `pack_weight`'s operand. The
kernels themselves run only on the card (chip_smoke.py holds them against
the plain versions there); these tests pin what they read and write.

Tolerances: none. Quantized codes are integers, and an int32 conv as a
float64 product of int8 values is exact in any summation order (every
partial sum is an integer below 2^53).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpupose.models.quantize as jq
import tpupose_torch.ops.int8_conv as tk
from tests.test_torch_quantize import _quant_pair

torch.set_num_threads(1)


def _round_up(v, m):
    return -(-v // m) * m


@pytest.mark.parametrize("cin", [3, 16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_quantize_nhwc_plain_is_quantize_input_channels_last(dtype, cin):
    rng = np.random.default_rng(cin)
    inv = torch.tensor([127.0 / 6.0])
    if dtype == torch.int8:
        x = torch.as_tensor(rng.integers(-127, 128, size=(2, cin, 5, 7)).astype(np.int8))
    else:
        x = torch.as_tensor(rng.standard_normal((2, cin, 5, 7)).astype(np.float32) * 3)
        x = x.to(dtype)
        x[1, cin - 1, 4, 6] = float("nan")
    got = tk.quantize_nhwc_plain(x, inv)
    cp = _round_up(cin, 16)
    assert got.dtype == torch.int8 and tuple(got.shape) == (2, 5, 7, cp)
    ref = x if dtype == torch.int8 else tk.quantize_input(x, inv)
    torch.testing.assert_close(got[..., :cin], ref.permute(0, 2, 3, 1), rtol=0, atol=0)
    assert not got[..., cin:].any()
    if dtype != torch.int8:
        assert got[1, 4, 6, cin - 1] == 0  # NaN quantizes to 0, as XLA converts it
        assert got.abs().max() == 127  # the clamp is reached
    assert got.is_contiguous()


def _im2col_nhwc(xq, kh, kw, stride, dilation):
    """(N, H, W, Cp) int8 -> (N*Ho*Wo, kh*kw*Cp) float64 rows in K2b's
    (r, c, ci) order, zero outside the image (padding k//2)."""
    n, h, w, cp = xq.shape
    ph, pw = kh // 2, kw // 2
    ho, wo = tk.out_size(h, kh, stride, dilation), tk.out_size(w, kw, stride, dilation)
    padded = torch.zeros((n, h + 2 * ph, w + 2 * pw, cp), dtype=torch.float64)
    padded[:, ph:ph + h, pw:pw + w] = xq.to(torch.float64)
    taps = []
    for r in range(kh):
        for c in range(kw):
            rows = padded[:, r * dilation:, c * dilation:]
            taps.append(rows[:, :(ho - 1) * stride + 1:stride, :(wo - 1) * stride + 1:stride])
    cols = torch.stack(taps, dim=3)  # (n, ho, wo, kh*kw, cp)
    return cols.reshape(n * ho * wo, kh * kw * cp), (n, ho, wo)


GEMM_CASES = {  # name: (cin, cout, k, stride, dilation, h, w)
    "1x1_16_48": (16, 48, 1, 1, 1, 7, 9),
    "3x3_48_48": (48, 48, 3, 1, 1, 7, 9),
    "3x3_s2_64_96": (64, 96, 3, 2, 1, 9, 11),
    "3x3_d2_48_96": (48, 96, 3, 1, 2, 8, 7),
    "1x1_s2_64_48": (64, 48, 1, 2, 1, 8, 9),
    "3x3_16_96": (16, 96, 3, 1, 1, 13, 13),
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_gemm_operands_reproduce_conv_exact(case):
    cin, cout, k, stride, dil, h, w = GEMM_CASES[case]
    rng = np.random.default_rng(7)
    wq = torch.as_tensor(rng.integers(-127, 128, size=(cout, cin, k, k)).astype(np.int8))
    x = torch.as_tensor(rng.standard_normal((2, cin, h, w)).astype(np.float32) * 2)
    inv = torch.tensor([127.0 / 5.0])
    xq = tk.quantize_nhwc_plain(x, inv)
    a, (n, ho, wo) = _im2col_nhwc(xq, k, k, stride, dil)
    assert a.shape[0] % 128 != 0  # a ragged last tile of output pixels
    wk = tk.pack_weight(wq)
    kk = cin * k * k
    assert tk.channels_last(cin)
    assert tuple(wk.shape) == (_round_up(cout, 64), _round_up(kk, 32))
    assert not wk[cout:].any() and not wk[:, kk:].any()
    a_pad = torch.zeros((a.shape[0], wk.shape[1]), dtype=torch.float64)
    a_pad[:, :kk] = a
    acc = (a_pad @ wk.to(torch.float64).T)[:, :cout]
    got = acc.reshape(n, ho, wo, cout).permute(0, 3, 1, 2).to(torch.int32)
    ref = tk.conv_exact(tk.quantize_input(x, inv), wq, stride, dil)
    assert ref.abs().max() > 127 * 127  # a real sum over many taps
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("cin,k", [(16, 1), (16, 3), (48, 3), (64, 1)])
def test_packed_rows_are_the_jax_hwio_weights(cin, k):
    rng = np.random.default_rng(8)
    qj, qt = _quant_pair(rng, cin, 48, k, absmax=3.0)
    hwio = np.asarray(qj["weight_q"])  # (kh, kw, cin, cout)
    np.testing.assert_array_equal(qt.weight_q.numpy(), hwio.transpose(3, 2, 0, 1))
    kk = k * k * cin
    for co in range(48):
        np.testing.assert_array_equal(qt.weight_k[co, :kk].numpy(),
                                      hwio[..., co].reshape(-1), err_msg=f"co {co}")
    # and the GEMM over the JAX package's own quantized input gives its conv
    x = rng.standard_normal((1, 5, 6, cin)).astype(np.float32) * 2
    xq_j = jq._quant_input(qj, jnp.asarray(x))
    a, _ = _im2col_nhwc(torch.as_tensor(np.array(xq_j)), k, k, 1, 1)
    acc = a @ qt.weight_k[:48, :kk].to(torch.float64).T
    ref = np.asarray(jq._int8_conv(xq_j, qj["weight_q"]))
    np.testing.assert_array_equal(acc.reshape(ref.shape).numpy().astype(np.int32), ref)


@pytest.mark.parametrize("cin", [3, 5, 24])
def test_other_cin_keep_the_gather_layout(cin):
    rng = np.random.default_rng(9)
    wq = torch.as_tensor(rng.integers(-127, 128, size=(70, cin, 3, 3)).astype(np.int8))
    wk = tk.pack_weight(wq)
    kk = cin * 9
    assert not tk.channels_last(cin)
    assert tuple(wk.shape) == (128, _round_up(kk, 32))
    np.testing.assert_array_equal(wk[:70, :kk].numpy(), wq.reshape(70, kk).numpy())
    assert not wk[70:].any() and not wk[:, kk:].any()


def test_channels_last_convs_stay_on_the_plain_version_on_the_cpu(monkeypatch):
    from tpupose_torch import kernels

    def no_kernel(name):
        raise AssertionError("no kernel may be reached from a CPU tensor")

    monkeypatch.setattr(kernels, "library", no_kernel)
    rng = np.random.default_rng(10)
    _, qt = _quant_pair(rng, 16, 24, 3)
    x = torch.as_tensor(rng.standard_normal((1, 16, 6, 5)).astype(np.float32))
    before = (tk.launches, tk.quantize_launches)
    mul, add = qt.dequant_vectors()
    got = qt(x)
    ref = tk.int8_conv_plain(x, qt.weight_q, qt.inv_scale(), mul, add, torch.float32)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert (tk.launches, tk.quantize_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tk.quantize_nhwc_cuda(x, qt.inv_scale())
    with pytest.raises(ValueError, match="CUDA"):
        tk.gemm_nhwc_cuda(tk.quantize_nhwc_plain(x, qt.inv_scale()), qt.weight_k, (3, 3),
                          mul, add, torch.float32)


# -- the channels-last modes (the served layout) --------------------------------


def _cl(x):
    return x.contiguous(memory_format=torch.channels_last)


def _layout_input(rng, dtype, shape):
    """An NCHW input of `shape`: int8 codes, or floats with a NaN planted in
    the first and the last image."""
    if dtype == torch.int8:
        return torch.as_tensor(rng.integers(-127, 128, size=shape).astype(np.int8))
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 3).to(dtype)
    x[0, 0, 1, 2] = x[-1, -1, -2, -1] = float("nan")
    return x


@pytest.mark.parametrize("cin", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_quantize_nhwc_plain_channels_last_mode(dtype, cin):
    """K2a's elementwise mode reads a channels-last input: its plain version
    on that input is today's on the NCHW one."""
    x = _layout_input(np.random.default_rng(cin + 1), dtype, (2, cin, 5, 7))
    inv = torch.tensor([127.0 / 6.0])
    got = tk.quantize_nhwc_plain(_cl(x), inv)
    assert got.is_contiguous() and tuple(got.shape) == (2, 5, 7, cin)
    assert torch.equal(got, tk.quantize_nhwc_plain(x, inv))
    # with Cin % 16 == 0 the NHWC int8 copy is the input's own NHWC view
    if dtype == torch.int8:
        assert torch.equal(got, _cl(x).permute(0, 2, 3, 1))


@pytest.mark.parametrize("out", ["dequantize", "requant_relu"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_int8_conv_plain_channels_last_mode(dtype, cin, stride, out):
    """K2b's NHWC-output mode: the plain version on a channels-last input is
    today's on the NCHW input, its result channels-last."""
    rng = np.random.default_rng(cin * 10 + stride)
    cout = 24
    x = _layout_input(rng, dtype, (2, cin, 9, 7))
    wq = torch.as_tensor(rng.integers(-127, 128, size=(cout, cin, 3, 3)).astype(np.int8))
    inv = torch.tensor([127.0 / 6.0])
    out_dtype = torch.int8 if out == "requant_relu" else (
        torch.float32 if dtype == torch.int8 else dtype)
    # int8 outputs spread over [0, 127], past both clamps
    mul = torch.as_tensor(rng.uniform(0.5, 1.5, cout).astype(np.float32)) / (
        200.0 if out_dtype == torch.int8 else 2000.0)
    add = torch.as_tensor(rng.standard_normal(cout).astype(np.float32))
    got = tk.int8_conv_plain(_cl(x), wq, inv, mul, add, out_dtype, stride)
    ref = tk.int8_conv_plain(x, wq, inv, mul, add, out_dtype, stride)
    assert got.is_contiguous(memory_format=torch.channels_last) and not got.is_contiguous()
    assert ref.is_contiguous() and got.dtype == out_dtype
    assert torch.equal(got, ref)
    if out == "requant_relu":
        assert ref.min() == 0 and ref.max() == 127  # both clamps reached
    # the models' dispatch keeps the layout on the CPU too
    assert torch.equal(tk.int8_conv(_cl(x), wq, None, inv, mul, add, out_dtype, stride), ref)


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_gemm_reads_an_int8_channels_last_input_in_place(case):
    """An int8 channels-last activation with Cin % 16 == 0 is K2b's operand as
    it is (no K2a): its NHWC view, im2col'd in K2b's (r, c, ci) order against
    `pack_weight`'s rows, gives the exact conv, whose NHWC output is the
    channels-last result."""
    cin, cout, k, stride, dil, h, w = GEMM_CASES[case]
    rng = np.random.default_rng(11)
    wq = torch.as_tensor(rng.integers(-127, 128, size=(cout, cin, k, k)).astype(np.int8))
    x = _cl(torch.as_tensor(rng.integers(-127, 128, size=(2, cin, h, w)).astype(np.int8)))
    view = x.permute(0, 2, 3, 1)
    assert view.is_contiguous() and view.data_ptr() == x.data_ptr()
    a, (n, ho, wo) = _im2col_nhwc(view, k, k, stride, dil)
    wk = tk.pack_weight(wq)
    kk = cin * k * k
    acc = (a @ wk[:, :kk].to(torch.float64).T)[:, :cout].to(torch.int32)
    got = acc.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)  # K2b's NHWC store
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, tk.conv_exact(x, wq, stride, dil))
    assert torch.equal(got, tk.conv_exact(x.contiguous(), wq, stride, dil))
