"""int8 x int8 -> int32 convolution with its input quantization (kernel K2).

Counterpart of the int8 conv ops of `tpupose/models/quantize.py`
(`_quant_input`, `_int8_conv`, the dequantize epilogue of
`quantized_conv_apply`, `_requant_relu`), which the JAX package leaves to
XLA. Activations are (N, C, H, W) tensors, NCHW or channels-last
(`ops.layout`); the output has the input's layout. Weights are OIHW int8.
One call computes

    acc = conv(q(x), weight_q)        int32, stride s, dilation d, pad k//2
    q(x) = clamp(round(x * inv), -127, 127) for a float x (0 for NaN),
           x for an int8 x
    out = acc * mul + add             to `out_dtype` (f32 / bf16), or
    out = clamp(round(acc * mul + add), 0, 127)  to int8 (requant-relu)

with `mul` and `add` per output channel (`add` may be None).

* `int8_conv_plain` is the plain torch version: an exact int32 conv
  (`F.conv2d` in float64 on int8 values: every partial sum is an integer
  below 2^53, so any summation order is exact) between the quantization and
  the epilogue, each rounding as the JAX package does.
* `int8_conv_cuda` runs the hand-written kernels of
  `tpupose_torch/csrc/int8_conv.cu` on the weights in the layout they read
  (`pack_weight`), by the input's layout:
  - NCHW (contiguous). For Cin % 16 == 0 (every conv of the main path but
    the two RGB stems) two launches: K2a quantizes x once into a
    channels-last int8 copy through a shared-memory transpose
    (`quantize_nhwc_plain` is its plain version) and K2b, an implicit GEMM
    over it, computes the conv and the epilogue into an NCHW output. A conv
    whose Cin*kh*kw fits one K step of 32 (`stem_path`: the stems' 3 x 3 x
    3) goes to the stem kernel, which quantizes an input halo once into
    shared memory (`stem_tile` sizes its blocks); any other Cin to the
    gather kernel, which quantizes as it loads NCHW.
  - Channels-last, the served layout. For Cin % 16 == 0, K2a's elementwise
    mode quantizes the NHWC input into an NHWC int8 copy, or, for an int8
    input, nothing runs and K2b reads the input in place; K2b writes a
    channels-last output. The stem kernel's NHWC mode reads the stems'
    channels-last input and writes a channels-last output. Any other Cin
    raises: the gather kernel reads NCHW only, and takes a channels-last
    input only through the caller's own conversion.
  - Either layout: K2b takes its halo path where `halo_path` holds (3 x 3,
    stride 1, by the shape alone): a block computes a `halo_tile` patch of
    output pixels from their input halo, copied into shared memory once,
    in place of one copy a tap; bit-equal to the per-tap path.
  `quantize_nhwc_cuda`, `gemm_nhwc_cuda` and `gather_conv_cuda` launch K2a,
  K2b and the gather kernel alone. `launches` counts K2b, stem and gather
  launches, one per conv; `stem_launches` the stem kernel's alone;
  `nhwc_launches` the K2b and stem launches that wrote a channels-last
  output; `requant_launches` the K2b launches that wrote the next conv's
  int8 input; `halo_launches` the K2b launches on the halo path;
  `quantize_launches` K2a launches, `quantize_cl_launches` those of its
  elementwise mode.
* The requantizing mode, for a conv whose activated output one other int8
  conv alone reads (`models.layers.chain_out` decides where): one call
  writes that conv's int8 input,

      out = quantize_input(act(epilogue(acc, mul, add, mid_dtype)), inv_next)

  today's three steps (K2b's dequantize store, the activation-only pass of
  `ops.epilogue`, the next conv's K2a), which `int8_conv_requant_plain`
  composes and K2b computes in its epilogue on the card
  (`int8_conv_requant_cuda`), bit for bit the same codes.
* `int8_conv` and `int8_conv_requant` are what the models call: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel, which
  raises rather than fall back.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpupose_torch.ops import epilogue as _epilogue
from tpupose_torch.ops.layout import is_channels_last, memory_format_of

#: Launches of K2b and of the gather kernel, one per conv run on the card
#: (reset freely; read by chip_smoke.py).
launches = 0
#: Launches of K2a, the quantize-to-channels-last pass (reset freely).
quantize_launches = 0
#: Launches of K2a's elementwise mode on a channels-last input, also
#: counted in `quantize_launches` (reset freely).
quantize_cl_launches = 0
#: Launches of the stem kernel, also counted in `launches` (reset freely).
stem_launches = 0
#: Launches of K2b and of the stem kernel that wrote a channels-last
#: output, also counted in `launches` (reset freely).
nhwc_launches = 0
#: Launches of K2b in its requantizing mode, which wrote the next conv's
#: int8 input, also counted in `launches` and `nhwc_launches` (reset
#: freely).
requant_launches = 0
#: Launches of K2b on the halo path (`halo_path`), also counted in
#: `launches` (reset freely).
halo_launches = 0

#: Tile of the kernel's weight operand: rows padded to BLOCK_N, K to BLOCK_K.
BLOCK_N = 64
BLOCK_K = 32
#: Channel granule of the channels-last path: Cin % CHANNELS == 0 takes it,
#: and its int8 copy pads channels to a multiple of CHANNELS.
CHANNELS = 16

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _round_up(v, m):
    return -(-v // m) * m


def channels_last(cin):
    """True where the conv takes the channels-last path (K2a + K2b)."""
    return cin % CHANNELS == 0


def stem_path(cin, kh, kw):
    """True where the conv takes the stem kernel: not channels-last, and all
    of K = Cin*kh*kw in one K step (the RGB stems' 3 x 3 x 3)."""
    return not channels_last(cin) and cin * kh * kw <= BLOCK_K


#: Output pixels a tile of the stem kernel covers, at most, unless one
#: output row is longer (its stage holds them for 64 channels in shared
#: memory).
STEM_TILE_PIXELS = 256


def stem_tile(ho, wo):
    """(rows, cols) of output a tile of the stem kernel covers: each output
    row split into equal runs of at most 512 columns, rounded up to 16, and
    as many whole rows as fit in STEM_TILE_PIXELS, at least one."""
    runs = -(-wo // 512)
    cols = _round_up(-(-wo // runs), 16)
    return max(1, min(ho, STEM_TILE_PIXELS // cols)), cols


#: Output pixels a K2b block computes: the rows of its GEMM tile.
GEMM_ROWS = 128
#: Shared memory of K2b's B ring: 4 stages of 64 weight rows x 64 K bytes.
GEMM_RING_BYTES = 4 * 64 * 64
#: Shared memory a K2b block may take on the halo path: four blocks an SM,
#: the most K2b's 128 registers a thread allow (228 KB of shared memory an
#: SM on Hopper, 1 KB of it reserved a block). At 3 blocks an SM (YOLOv3's
#: 3 x 3 256 -> 512 at 26 x 26, 62 KB) the halo path measured slower than the
#: per-tap path on an H100.
HALO_SMEM_LIMIT = 56 * 1024


@functools.lru_cache(maxsize=256)
def halo_tile(ho, wo):
    """(th, tw), the output patch of one K2b block on the halo path: at most
    GEMM_ROWS pixels, the fewest patches over an Ho x Wo output, then the
    smallest halo, (th + 2) * (tw + 2) pixels (the rows past th * tw and the
    patches' overhang past the output are wasted GEMM rows). Each side is
    the output's extent split into equal parts: 16 x 8 at 96 x 72, 7 x 18
    at 48 x 36, 9 x 13 at 52 x 52, 12 x 9 at 24 x 18 and 12 x 9. Cached:
    the wrapper asks at every launch."""
    best = None
    for tw_max in range(1, min(wo, GEMM_ROWS) + 1):
        nw = -(-wo // tw_max)
        tw = -(-wo // nw)
        nh = -(-ho // min(ho, GEMM_ROWS // tw))
        th = -(-ho // nh)
        key = (nh * nw, (th + 2) * (tw + 2), -tw)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return best[1]


def halo_layout(cin, tw):
    """(pixel, row) pitches of the halo path's halo in shared memory, in
    16-byte chunks, at Cin `cin` and patch width `tw` (3 x 3 taps): a pixel
    holds its Cp = Cin rounded up to 16 channels in an odd number of chunks
    (one spare where Cp / 16 is even), and a row of tw + 2 pixels a pitch
    that equals tw pixels' modulo 8, so that the eight consecutive pixels of
    an `ldmatrix` phase fall on eight bank groups, also across a patch row's
    end. The kernel takes this layout from `gemm_nhwc_cuda` (csrc/int8_conv.cu
    `Halo`) and has no copy of it."""
    pixel = (_round_up(cin, CHANNELS) // CHANNELS) | 1
    return pixel, (tw + 2) * pixel + (-2 * pixel) % 8


def halo_bytes(cin, th, tw):
    """Shared memory bytes of the halo: th + 2 rows of `halo_layout`'s
    pitch, rounded up to 128."""
    return _round_up((th + 2) * halo_layout(cin, tw)[1] * CHANNELS, 128)


def halo_smem(cin, th, tw):
    """Shared memory bytes of a halo-path block: its halo (`halo_bytes`), B
    ring and table of K offsets (one int32 a 16-byte chunk of its 64-byte K
    steps). The kernel reuses them for its epilogue's output tile, which
    takes less than HALO_SMEM_LIMIT at every store mode."""
    steps = -(-9 * _round_up(cin, CHANNELS) // 64)
    return halo_bytes(cin, th, tw) + GEMM_RING_BYTES + 16 * steps


def halo_fill(h, w):
    """The share of a halo-path launch's GEMM rows that compute an output
    pixel of an H x W output: H * W over `halo_tile`'s patches times
    GEMM_ROWS."""
    th, tw = halo_tile(h, w)
    return h * w / (-(-h // th) * -(-w // tw) * GEMM_ROWS)


#: The least `halo_fill` the halo path takes. On an H100 (80GB HBM3, 700 W),
#: K2b per-tap -> halo with a bf16 store: 0.556 -> 0.514 ms at HRNet-W48's
#: branch 1 (fill 0.964), but 0.613 -> 0.626 at YOLOv3-416's 3 x 3 64 -> 128
#: at 104 x 104 (0.939) and 0.578 -> 0.598 at 128 -> 256 at 52 x 52 (0.880):
#: the GEMM rows a patch wastes cost more than the halo saves.
HALO_MIN_FILL = 0.95
#: The fewest 64-byte K steps (9 x Cp / 64, rounded up) the halo path takes.
#: A block's whole halo lands before its first step, where the per-tap
#: path's A comes a step at a time behind the ring; with a short K that
#: wait is not made up. On the H100 above, with a bf16 store: 0.885 -> 0.908
#: ms at YOLOv3-416's 3 x 3 32 -> 64 at 208 x 208 (5 steps, fill 1), 0.795
#: -> 0.681 at HRNet-W48's branch 0, 48 -> 48 (7 steps).
HALO_MIN_STEPS = 6


@functools.lru_cache(maxsize=256)
def halo_path(cin, kh, kw, stride, dilation, h, w):
    """True where K2b takes the halo path: a channels-last conv of 3 x 3
    taps, stride 1, dilation 1 (its output as large as its input), of at
    least HALO_MIN_STEPS K steps, whose patches fill at least HALO_MIN_FILL
    of their GEMM rows (`halo_fill`) and whose block's shared memory
    (`halo_smem` at `halo_tile(h, w)`) is at most HALO_SMEM_LIMIT. The halo
    copies each input byte into shared memory once a block where the
    per-tap path copies it once a tap; a 1 x 1 or strided conv reads each
    input byte about once either way. On the main path: HRNet-W48's
    branches 0 and 1 and layer1; none of YOLOv3-416's convs."""
    if not (channels_last(cin) and kh == kw == 3 and stride == dilation == 1):
        return False
    return (-(-9 * _round_up(cin, CHANNELS) // 64) >= HALO_MIN_STEPS
            and halo_fill(h, w) >= HALO_MIN_FILL
            and halo_smem(cin, *halo_tile(h, w)) <= HALO_SMEM_LIMIT)


def pack_weight(weight_q):
    """(Cout, Cin, kh, kw) int8 -> the kernels' (Cout_pad, K_pad) int8
    operand: Cout padded to a multiple of 64 and K = Cin*kh*kw to a multiple
    of 32, with zeros. Row co holds weight_q[co] flattened in (r, c, ci)
    order (the HWIO order of the JAX package's `_int8_conv`) where
    `channels_last(Cin)`, else in (ci, r, c) order (the stem and gather
    kernels')."""
    cout, cin = weight_q.shape[:2]
    k = weight_q[0].numel()
    rows = weight_q.permute(0, 2, 3, 1) if channels_last(cin) else weight_q
    out = torch.zeros((_round_up(cout, BLOCK_N), _round_up(k, BLOCK_K)),
                      dtype=torch.int8, device=weight_q.device)
    out[:cout, :k] = rows.reshape(cout, k)
    return out


def out_size(size, k, stride=1, dilation=1):
    """Output extent of a conv padded k//2 on both sides."""
    return (size + 2 * (k // 2) - dilation * (k - 1) - 1) // stride + 1


def quantize_input(x, inv):
    """clamp(round(x * inv), -127, 127) as int8; the product in f32, round
    half to even (as jnp.round), NaN to 0 (as XLA converts it to int8)."""
    q = torch.clamp(torch.round(x.to(torch.float32) * inv), -127, 127)
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int8)


def quantize_nhwc_plain(x, inv):
    """K2a's plain version, in either of its modes: (N, C, H, W) f32 / bf16
    / int8, NCHW or channels-last -> (N, H, W, Cp) int8, Cp = C rounded up
    to 16, pad channels 0. A float x is quantized as `quantize_input`; an
    int8 x is copied through."""
    xq = x if x.dtype == torch.int8 else quantize_input(x, inv)
    n, c, h, w = xq.shape
    out = torch.zeros((n, h, w, _round_up(c, CHANNELS)), dtype=torch.int8,
                      device=x.device)
    out[..., :c] = xq.permute(0, 2, 3, 1)
    return out


def conv_exact(xq, weight_q, stride=1, dilation=1):
    """int8 x int8 -> int32 conv, exact: float64 on int8 values. cuDNN is
    kept out on the card, whose algorithms may transform the operands. The
    result has xq's layout."""
    kh, kw = weight_q.shape[2], weight_q.shape[3]
    fmt = memory_format_of(xq)
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(xq.to(torch.float64),
                     weight_q.to(torch.float64).contiguous(memory_format=fmt),
                     stride=stride, padding=(kh // 2, kw // 2), dilation=dilation)
    return y.to(torch.int32).contiguous(memory_format=fmt)


def epilogue(acc, mul, add, out_dtype):
    """int32 accumulators -> acc * mul (+ add) per output channel, rounded
    after each operation; cast to `out_dtype`, or requantized with relu to
    int8 when `out_dtype` is torch.int8."""
    y = acc.to(torch.float32) * mul[:, None, None]
    if add is not None:
        y = y + add[:, None, None]
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(y), 0, 127).to(torch.int8)
    return y.to(out_dtype)


def int8_conv_plain(x, weight_q, inv, mul, add, out_dtype, stride=1, dilation=1):
    """The plain torch version of the kernel (see the module docstring),
    its result in x's layout."""
    xq = x if x.dtype == torch.int8 else quantize_input(x, inv)
    return epilogue(conv_exact(xq, weight_q, stride, dilation), mul, add, out_dtype)


def int8_conv_requant_plain(x, weight_q, inv, mul, add, mid_dtype, act, inv_next,
                            stride=1, dilation=1):
    """The plain version of the requantizing mode, today's three steps
    composed: the dequantize epilogue to `mid_dtype`, the activation `act`
    (None, "relu" or "leaky") as `ops.epilogue.bias_act_plain` applies it,
    and `quantize_input` at the next conv's `inv_next`. Returns the next
    conv's int8 input, in x's layout."""
    y = int8_conv_plain(x, weight_q, inv, mul, add, mid_dtype, stride, dilation)
    q = quantize_input(_epilogue.bias_act_plain(y, act=act), inv_next)
    return q.contiguous(memory_format=memory_format_of(y))


def _kernel(name, argtypes):
    from tpupose_torch import kernels

    fn = getattr(kernels.library("int8_conv"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_GATHER_ARGS = [_P, _I] + [_P] * 5 + [_I] * 15 + [_P]
_STEM_ARGS = [_P, _I] + [_P] * 5 + [_I] * 18 + [_P]
_QUANTIZE_ARGS = [_P, _I, _P, _P] + [_I] * 5 + [_P]
_QUANTIZE_CL_ARGS = [_P, _I, _P, _P, ctypes.c_longlong, _P]
_GEMM_ARGS = [_P] * 5 + [_I] * 21 + [_P]
_REQUANT_ARGS = [_P] * 5 + [_I] * 2 + [_P] + [_I] * 19 + [_P]
_ACTS = {None: 0, "relu": 1, "leaky": 2}


def _check_launch(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _check_inv(x, inv):
    if x.dtype != torch.int8 and (inv.dtype != torch.float32 or inv.device != x.device
                                  or inv.numel() != 1):
        raise ValueError("int8_conv_cuda: inv must be one f32 on the input's device")


def quantize_nhwc_cuda(x, inv):
    """One launch of K2a: `quantize_nhwc_plain` on the card.

    x: (N, C, H, W) f32, bf16 or int8 on a CUDA device, either contiguous
    NCHW (the transposing mode, any C) or channels-last with C % 16 == 0
    (the elementwise mode); inv: one f32 1 / x_scale on it (ignored for an
    int8 x). Returns the (N, H, W, Cp) int8 copy. Launches on the current
    stream, does not synchronize, and raises on any other input and on a
    failed launch.
    """
    global quantize_launches, quantize_cl_launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quantize_nhwc_cuda needs CUDA tensors, got {dev}")
    nhwc = is_channels_last(x) and channels_last(x.shape[1])
    if x.dtype not in _CODES or x.dim() != 4 or not (x.is_contiguous() or nhwc):
        raise ValueError(f"quantize_nhwc_cuda needs a contiguous NCHW, or a channels-last "
                         f"16k-channel, f32 / bf16 / int8 input, got {tuple(x.shape)} "
                         f"{x.dtype} strides {x.stride()}")
    _check_inv(x, inv)
    n, c, h, w = x.shape
    cp = _round_up(c, CHANNELS)
    if cp * h * w >= 2**31:
        raise ValueError("quantize_nhwc_cuda: one image must hold fewer than "
                         "2^31 elements")
    y = torch.empty((n, h, w, cp), dtype=torch.int8, device=dev)
    if y.numel() == 0:
        return y
    inv_p = None if x.dtype == torch.int8 else inv.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if nhwc:
            rc = _kernel("tpupose_quantize_nhwc_cl", _QUANTIZE_CL_ARGS)(
                x.data_ptr(), _CODES[x.dtype], inv_p, y.data_ptr(), y.numel(), stream)
        else:
            rc = _kernel("tpupose_quantize_nhwc", _QUANTIZE_ARGS)(
                x.data_ptr(), _CODES[x.dtype], inv_p, y.data_ptr(), n, c, h, w, cp, stream)
    _check_launch(rc, "int8_conv quantize (K2a)")
    quantize_launches += 1
    quantize_cl_launches += nhwc
    return y


def _conv_geometry(what, dev, cin, h, w, weight_k, kernel_hw, mul, add, stride,
                   dilation):
    """Checks the weight operand and the epilogue vectors of a conv on a
    (N, cin, h, w) input; returns (ho, wo, kpad)."""
    kh, kw = kernel_hw
    cout = mul.shape[0]
    kpad = _round_up(cin * kh * kw, BLOCK_K)
    if (weight_k.dtype != torch.int8 or weight_k.device != dev
            or tuple(weight_k.shape) != (_round_up(cout, BLOCK_N), kpad)
            or not weight_k.is_contiguous()):
        raise ValueError(f"{what}: packed weight {tuple(weight_k.shape)} "
                         f"{weight_k.dtype} does not fit Cin={cin} k={kh}x{kw} "
                         f"Cout={cout}")
    for v in [mul] + ([] if add is None else [add]):
        if v.dtype != torch.float32 or v.device != dev or not v.is_contiguous():
            raise ValueError(f"{what}: mul and add must be contiguous f32 on the "
                             f"input's device")
    if add is not None and add.shape != mul.shape:
        raise ValueError(f"{what}: add {tuple(add.shape)} != mul {tuple(mul.shape)}")
    ho, wo = out_size(h, kh, stride, dilation), out_size(w, kw, stride, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"{what}: empty output for {h}x{w} input")
    if max(cin * h * w, cout * ho * wo) >= 2**31:
        raise ValueError(f"{what}: one image must hold fewer than 2^31 elements "
                         f"in and out")
    return ho, wo, kpad


def _output(n, cout, ho, wo, out_dtype, dev, nhwc_out):
    """A new (N, Cout, Ho, Wo) tensor, channels-last where `nhwc_out`."""
    fmt = torch.channels_last if nhwc_out else torch.contiguous_format
    return torch.empty((n, cout, ho, wo), dtype=out_dtype, device=dev, memory_format=fmt)


def gemm_nhwc_cuda(xq, weight_k, kernel_hw, mul, add, out_dtype, stride=1,
                   dilation=1, nhwc_out=False, requant=None):
    """One launch of K2b: the int8 conv of an (N, H, W, Cin) int8 tensor
    (Cin % 16 == 0: K2a's output, or the NHWC view of an int8 channels-last
    activation) with the epilogue, to a new (N, Cout, Ho, Wo) tensor, NCHW,
    or channels-last where `nhwc_out`. Other arguments as
    `int8_conv_cuda`'s. `requant` = (mid_dtype, act, inv_next) selects the
    requantizing mode (`int8_conv_requant_cuda`), whose output is the
    channels-last int8 input of the next conv (`out_dtype` int8 and
    `nhwc_out` required). Launches on the current stream, does not
    synchronize, and raises on a failed launch."""
    global launches, nhwc_launches, requant_launches, halo_launches
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"gemm_nhwc_cuda needs CUDA tensors, got {dev}")
    if (xq.dtype != torch.int8 or xq.dim() != 4 or not xq.is_contiguous()
            or not channels_last(xq.shape[3])):
        raise ValueError(f"gemm_nhwc_cuda needs a contiguous (N, H, W, 16k) int8 "
                         f"input, got {tuple(xq.shape)} {xq.dtype}")
    if out_dtype not in _CODES:
        raise TypeError(f"gemm_nhwc_cuda writes f32 / bf16 / int8, not {out_dtype}")
    if requant is not None:
        mid_dtype, act, inv_next = requant
        if out_dtype != torch.int8 or not nhwc_out:
            raise ValueError("gemm_nhwc_cuda: the requantizing mode writes channels-last int8")
        if mid_dtype not in (torch.float32, torch.bfloat16) or act not in _ACTS:
            raise ValueError(f"gemm_nhwc_cuda: requantizing through {mid_dtype} with "
                             f"activation {act!r}")
        if (inv_next.dtype != torch.float32 or inv_next.device != dev
                or inv_next.numel() != 1):
            raise ValueError("gemm_nhwc_cuda: inv_next must be one f32 on the input's device")
    n, h, w, cin = xq.shape
    kh, kw = kernel_hw
    ho, wo, kpad = _conv_geometry("gemm_nhwc_cuda", dev, cin, h, w, weight_k,
                                  kernel_hw, mul, add, stride, dilation)
    cout = mul.shape[0]
    y = _output(n, cout, ho, wo, out_dtype, dev, nhwc_out)
    if n == 0:
        return y
    add_p = None if add is None else add.data_ptr()
    halo = halo_path(cin, kh, kw, stride, dilation, h, w)
    tile = (0,) * 5
    if halo:
        th, tw = halo_tile(ho, wo)
        tile = (th, tw, *halo_layout(cin, tw), halo_bytes(cin, th, tw))
    geometry = (n, cin, h, w, cout, kh, kw, stride, kh // 2, kw // 2, dilation, ho, wo, kpad)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if requant is None:
            rc = _kernel("tpupose_int8_conv_nhwc", _GEMM_ARGS)(
                xq.data_ptr(), weight_k.data_ptr(), mul.data_ptr(), add_p, y.data_ptr(),
                _CODES[out_dtype], *geometry, int(nhwc_out), *tile, stream)
        else:
            rc = _kernel("tpupose_int8_conv_nhwc_requant", _REQUANT_ARGS)(
                xq.data_ptr(), weight_k.data_ptr(), mul.data_ptr(), add_p, y.data_ptr(),
                _CODES[mid_dtype], _ACTS[act], inv_next.data_ptr(), *geometry, *tile, stream)
    _check_launch(rc, "int8_conv GEMM (K2b)")
    launches += 1
    nhwc_launches += nhwc_out
    requant_launches += requant is not None
    halo_launches += halo
    return y


def _cuda_input(what, x, inv, out_dtype, nchw=True):
    """Checks a conv input, a contiguous NCHW one where `nchw`; returns its
    device."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    if x.dtype not in _CODES or out_dtype not in _CODES:
        raise TypeError(f"{what} takes f32 / bf16 / int8, got {x.dtype} -> {out_dtype}")
    if x.dim() != 4 or (nchw and not x.is_contiguous()):
        raise ValueError(f"{what} needs a contiguous NCHW input, got {tuple(x.shape)} "
                         f"strides {x.stride()}")
    _check_inv(x, inv)
    return dev


def _direct_launch(what, dev, stem, x, weight_k, kernel_hw, inv, mul, add, out_dtype,
                   stride, dilation, nhwc=False):
    """One launch of the stem kernel (`stem`) or of the gather kernel on an
    input that `_cuda_input` has passed (on `dev`), NCHW, or channels-last
    where `nhwc` (the stem kernel's NHWC mode), to a new (N, Cout, Ho, Wo)
    tensor in the input's layout."""
    global launches, stem_launches, nhwc_launches
    n, cin, h, w = x.shape
    kh, kw = kernel_hw
    ho, wo, kpad = _conv_geometry(what, dev, cin, h, w, weight_k, kernel_hw, mul, add,
                                  stride, dilation)
    cout = mul.shape[0]
    y = _output(n, cout, ho, wo, out_dtype, dev, nhwc)
    if n == 0:
        return y
    args = (x.data_ptr(), _CODES[x.dtype], weight_k.data_ptr(),
            None if x.dtype == torch.int8 else inv.data_ptr(), mul.data_ptr(),
            None if add is None else add.data_ptr(), y.data_ptr(),
            _CODES[out_dtype], n, cin, h, w, cout, kh, kw, stride, kh // 2,
            kw // 2, dilation, ho, wo, kpad)
    if stem:
        args += (*stem_tile(ho, wo), int(nhwc))
    elif nhwc:
        raise ValueError(f"{what}: the gather kernel reads NCHW only")
    fn = (_kernel("tpupose_int8_stem", _STEM_ARGS) if stem
          else _kernel("tpupose_int8_conv", _GATHER_ARGS))
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(rc, "int8_conv stem" if stem else "int8_conv gather")
    launches += 1
    stem_launches += stem
    nhwc_launches += nhwc
    return y


def gather_conv_cuda(x, weight_k, kernel_hw, inv, mul, add, out_dtype, stride=1,
                     dilation=1):
    """One launch of the gather kernel, which takes any Cin (the main path
    sends it none since the stems have their own kernel; chip_smoke.py
    times it there). Arguments as `int8_conv_cuda`'s."""
    dev = _cuda_input("gather_conv_cuda", x, inv, out_dtype)
    return _direct_launch("gather_conv_cuda", dev, False, x, weight_k, kernel_hw, inv, mul,
                          add, out_dtype, stride, dilation)


def int8_conv_cuda(x, weight_k, kernel_hw, inv, mul, add, out_dtype, stride=1,
                   dilation=1):
    """One int8 conv on the card, its output in x's layout. NCHW x: K2a
    then K2b where `channels_last(Cin)`, one launch of the stem kernel where
    `stem_path(Cin, kh, kw)`, else one launch of the gather kernel.
    Channels-last x: K2a's elementwise mode (none for an int8 x) then K2b,
    both NHWC, where `channels_last(Cin)`; the stem kernel's NHWC mode
    where `stem_path(Cin, kh, kw)`; else it raises.

    Args:
      x: (N, Cin, H, W) f32, bf16 or int8 on a CUDA device, contiguous NCHW
        or channels-last.
      weight_k: `pack_weight(weight_q)`, on the same device.
      kernel_hw: (kh, kw) of weight_q.
      inv: 1-element f32 tensor 1 / x_scale (ignored for an int8 x).
      mul, add: (Cout,) f32 (add may be None).
      out_dtype: torch.float32 / torch.bfloat16 (dequantize) or torch.int8
        (requantize-relu).
    Launches on the current stream, does not synchronize, and raises on
    anything the kernels do not take (an input neither contiguous NCHW nor
    channels-last among it) and on a failed launch of either pass.
    """
    nhwc = is_channels_last(x)
    dev = _cuda_input("int8_conv_cuda", x, inv, out_dtype, nchw=not nhwc)
    cin = x.shape[1]
    if channels_last(cin):
        _conv_geometry("int8_conv_cuda", dev, cin, x.shape[2], x.shape[3], weight_k,
                       kernel_hw, mul, add, stride, dilation)
        # an int8 channels-last activation is K2b's operand as it is
        xq = (x.permute(0, 2, 3, 1) if nhwc and x.dtype == torch.int8
              else quantize_nhwc_cuda(x, inv))
        return gemm_nhwc_cuda(xq, weight_k, kernel_hw, mul, add, out_dtype, stride,
                              dilation, nhwc_out=nhwc)
    stem = stem_path(cin, *kernel_hw)
    if nhwc and not stem:
        raise ValueError(f"int8_conv_cuda: no kernel takes a channels-last input of "
                         f"{cin} channels (the gather kernel reads NCHW); convert it "
                         f"with .contiguous() first")
    return _direct_launch("int8_conv_cuda", dev, stem, x, weight_k, kernel_hw, inv, mul, add,
                          out_dtype, stride, dilation, nhwc=nhwc)


def int8_conv_requant_cuda(x, weight_k, kernel_hw, inv, mul, add, mid_dtype, act,
                           inv_next, stride=1, dilation=1):
    """One int8 conv on the card in the requantizing mode: K2a's
    elementwise mode (none for an int8 x) then one launch of K2b, which
    writes `int8_conv_requant_plain`'s codes, the next conv's channels-last
    int8 input (N, Cout, Ho, Wo).

    x: (N, Cin, H, W) f32, bf16 or int8 on a CUDA device, channels-last,
    Cin % 16 == 0; mid_dtype: torch.float32 or torch.bfloat16, the type the
    dequantized value is rounded to; act: None, "relu" or "leaky";
    inv_next: one f32 1 / x_scale of the next conv on x's device; other
    arguments as `int8_conv_cuda`'s. Launches on the current stream, does
    not synchronize, and raises on any other input and on a failed launch.
    """
    dev = _cuda_input("int8_conv_requant_cuda", x, inv, torch.int8, nchw=False)
    cin = x.shape[1]
    if not (is_channels_last(x) and channels_last(cin)):
        raise ValueError(f"int8_conv_requant_cuda needs a channels-last input of 16k "
                         f"channels, got {tuple(x.shape)} strides {x.stride()}")
    _conv_geometry("int8_conv_requant_cuda", dev, cin, x.shape[2], x.shape[3], weight_k,
                   kernel_hw, mul, add, stride, dilation)
    xq = x.permute(0, 2, 3, 1) if x.dtype == torch.int8 else quantize_nhwc_cuda(x, inv)
    return gemm_nhwc_cuda(xq, weight_k, kernel_hw, mul, add, torch.int8, stride, dilation,
                          nhwc_out=True, requant=(mid_dtype, act, inv_next))


def int8_conv(x, weight_q, weight_k, inv, mul, add, out_dtype, stride=1,
              dilation=1):
    """Dispatch for the models: the plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor (raising on failure and on an input
    neither contiguous NCHW nor channels-last); the output has x's
    layout."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, weight_q, inv, mul, add, out_dtype, stride,
                               dilation)
    return int8_conv_cuda(x, weight_k, tuple(weight_q.shape[2:]), inv, mul, add,
                          out_dtype, stride, dilation)


def int8_conv_requant(x, weight_q, weight_k, inv, mul, add, mid_dtype, act, inv_next,
                      stride=1, dilation=1):
    """Dispatch of the requantizing mode for the models: the plain version
    for a CPU tensor, the kernel for a CUDA tensor (raising on failure and
    on an input it does not take); the next conv's int8 input, in x's
    layout."""
    if x.device.type == "cpu":
        return int8_conv_requant_plain(x, weight_q, inv, mul, add, mid_dtype, act, inv_next,
                                       stride, dilation)
    return int8_conv_requant_cuda(x, weight_k, tuple(weight_q.shape[2:]), inv, mul, add,
                                  mid_dtype, act, inv_next, stride, dilation)
