"""Step-by-step CPU emulations of two CUDA kernels' order of operations, held
against the plain versions and the JAX package.

* K3, the batched masked LAP (`tpupose_torch/csrc/lap.cu`): the argmin as
  two warp minimum reductions, first over an order-preserving integer key
  of (reach + 0.0), then over the column indices at that key; delta as the
  winning column's own reach; and the potential update u += delta * bump
  deferred: a row's u is read when it enters the tree and the later
  deltas are added to it in step order, written back after the
  augmentation. Held torch.equal to `masked_lap_plain` and to
  `jax.vmap(tpupose.ops.lap.masked_lap)` on integer-cost ties, maximized
  scores with zero entries (negated into -0.0, which an unrounded key
  would order before +0.0), empty problems and both orientations, at the
  tracker's shapes.
* The stem kernel of `tpupose_torch/csrc/int8_conv.cu`: per block of
  `stem_tile` output pixels, a halo of quantized input (zero outside the
  image) and A rows gathered from it in (ci, r, c) order, against
  `pack_weight`'s rows. Held equal to `int8_conv_plain` and to the JAX
  package's `_int8_conv` for Cin 3 at stride 1 and 2. Its channels-last
  mode with the kernel's flat index arithmetic (a halo row is an input
  row's (w, ci) elements from a 16-byte chunk boundary, K positions at
  r * halo_stride + c * Cin + ci from their pixel) held equal to the plain
  version on the channels-last input, its result channels-last.

Tolerances: none. Both kernels are exact by design (the same f32
operations in the same order; int32 sums of int8 products).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.models.quantize as jq
from tpupose.ops.lap import masked_lap as j_masked_lap
from tpupose_torch.ops import int8_conv as tk
from tpupose_torch.ops import lap

torch.set_num_threads(1)

INF = np.float32(lap.INF)


def _key(x):
    """The kernel's order key of f32 values, as int64: x < y iff key(x) <
    key(y), with -0.0 keyed below +0.0."""
    b = torch.as_tensor(x, dtype=torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >> 31 == 1, b ^ 0xFFFFFFFF, b | 0x80000000)


def _unkey(k):
    b = int(k ^ (0x80000000 if k >> 31 else 0xFFFFFFFF))
    return torch.tensor([b], dtype=torch.int64).to(torch.int32).view(torch.float32)[0]


def _k3_one(cost, rv, cv, maximize):
    """K3 on one (R, C) problem, in the kernel's order of f32 operations."""
    R, C = cost.shape
    if R * C == 0:
        return torch.full((R,), -1, dtype=torch.long)
    x = -cost if maximize else cost.clone()
    ok = rv[:, None] & cv[None, :]
    keys = _key(x)[ok]
    has = keys.numel() > 0
    cmax = _unkey(int(keys.max())) if has else torch.tensor(0.0)
    cmin = _unkey(int(keys.min())) if has else torch.tensor(0.0)
    trans = R > C
    rs, cs = min(R, C), max(R, C)
    pad = (cmax + (cmax - cmin) * torch.tensor(float(rs))) + torch.tensor(1.0)
    c = torch.where(ok, x, pad)
    if trans:
        c = c.T.contiguous()
    u = torch.zeros(rs + 1)
    v = torch.zeros(cs)
    p = [-1] * (cs + 1)
    for i in range(rs):
        minv = torch.full((cs,), float(INF))
        used = torch.zeros(cs, dtype=torch.bool)
        way = [cs] * cs
        p[cs] = i
        j0, i0 = cs, i
        tree = []  # [row, u of the row plus the deltas since it entered]
        while True:
            if j0 < cs:
                used[j0] = True
            ui0 = u[i0].clone()
            tree.append([i0, ui0])
            cur = (c[i0] - ui0) - v
            better = ~used & (cur < minv)
            minv = torch.where(better, cur, minv)
            for j in torch.nonzero(better).flatten().tolist():
                way[j] = j0
            reach = torch.where(used, torch.tensor(float(INF)), minv)
            k = _key(reach + 0.0)  # -0.0 ties +0.0, as torch.argmin has it
            j0 = int(torch.nonzero(k == k.min())[0])
            delta = reach[j0]  # the winner's own value, sign of zero included
            i0 = p[j0]
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            for entry in tree:
                entry[1] = entry[1] + delta
            if i0 == -1:
                break
        for row, acc in tree:
            u[row] = acc
        while j0 != cs:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    out = torch.full((R,), -1, dtype=torch.long)
    for j in range(cs):
        if p[j] < 0:
            continue
        row, col = (j, p[j]) if trans else (p[j], j)
        if rv[row] and cv[col]:
            out[row] = col
    return out


def _problems(rng, batch, shape, kind):
    R, C = shape
    if kind == "ties":
        cost = rng.integers(0, 4, size=(batch, R, C)).astype(np.float32)
    else:
        cost = rng.uniform(0, 1, size=(batch, R, C)).astype(np.float32)
    if kind == "zeros":  # unmatched affinities: maximizing negates them into -0.0
        cost[rng.uniform(size=cost.shape) < 0.5] = 0.0
    rv = rng.uniform(size=(batch, R)) > rng.uniform(0, 0.6, size=(batch, 1))
    cv = rng.uniform(size=(batch, C)) > rng.uniform(0, 0.6, size=(batch, 1))
    rv[0] = False        # an empty problem: no valid row
    cv[1] = False        # and one with no valid column
    rv[-1] = cv[-1] = True  # and a full one
    return cost, rv, cv


def _jax_vmap(cost, rv, cv, maximize):
    fn = jax.jit(jax.vmap(functools.partial(j_masked_lap, maximize=maximize)))
    return np.asarray(fn(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv)))


@pytest.mark.parametrize("shape", [(12, 4), (24, 4), (16, 16), (40, 16)])
@pytest.mark.parametrize("kind,maximize", [("ties", True), ("ties", False),
                                           ("zeros", True), ("uniform", False)])
def test_k3_emulation_equals_plain_and_jax(shape, kind, maximize):
    rng = np.random.default_rng(sum(shape) * 7 + len(kind) + maximize)
    batch = 12 if max(shape) < 16 else 6
    cost, rv, cv = _problems(rng, batch, shape, kind)
    if kind == "zeros":
        assert np.signbit(-cost[cost == 0]).all()  # the -0.0 the key must tie
    tc, trv, tcv = torch.as_tensor(cost), torch.as_tensor(rv), torch.as_tensor(cv)
    got = torch.stack([_k3_one(tc[b], trv[b], tcv[b], maximize) for b in range(batch)])
    plain = lap.masked_lap_plain(tc, trv, tcv, maximize)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), _jax_vmap(cost, rv, cv, maximize))
    assert (got[0] == -1).all() and (got[1] == -1).all()
    assert (got[-1] >= 0).sum() == min(shape)


def test_k3_key_orders_floats_and_splits_signed_zeros():
    x = torch.tensor([-3e38, -2.5, -1e-30, -0.0, 0.0, 1e-30, 2.5, 3e38, float("inf")])
    k = _key(x)
    assert (k[1:] > k[:-1]).all()  # -0.0 keys strictly below +0.0 ...
    assert _key(torch.tensor(-0.0) + 0.0) == _key(torch.tensor(0.0))  # ... unless rounded
    assert all(float(_unkey(int(kk))) == float(xx) for kk, xx in zip(k, x))
    # a +0.0 before a -0.0 at the minimum: torch.argmin takes the first, and
    # so does the first index at the least key of (reach + 0.0); an unrounded
    # key would take the -0.0
    reach = torch.tensor([1.0, 0.0, -0.0, 0.5])
    keyed = _key(reach + 0.0)
    assert int(torch.nonzero(keyed == keyed.min())[0]) == int(torch.argmin(reach)) == 1
    assert int(torch.argmin(_key(reach))) == 2


def _stem_emulation(x, wk, inv, mul, add, out_dtype, kh, kw, stride):
    """The stem kernel on NCHW x, block by block of `stem_tile` pixels."""
    n, cin, h, w = x.shape
    ph, pw = kh // 2, kw // 2
    ho, wo = tk.out_size(h, kh, stride), tk.out_size(w, kw, stride)
    rows, cols = tk.stem_tile(ho, wo)
    assert cols % 16 == 0 and rows * cols <= tk.STEM_TILE_PIXELS or rows == 1
    cout = mul.shape[0]
    k = cin * kh * kw
    xq = x if x.dtype == torch.int8 else tk.quantize_input(x, inv)
    ci, r, c = np.unravel_index(np.arange(k), (cin, kh, kw))
    weights = wk[:cout, :tk.BLOCK_K].to(torch.float64)
    hr = (rows - 1) * stride + kh
    hc = (cols - 1) * stride + kw
    out = torch.empty((n, cout, ho, wo), dtype=out_dtype)
    for img in range(n):
        for oh0 in range(0, ho, rows):
            for ow0 in range(0, wo, cols):
                ih0, iw0 = oh0 * stride - ph, ow0 * stride - pw
                halo = torch.zeros((cin, hr, hc), dtype=torch.int8)
                ys, xs = slice(max(ih0, 0), min(ih0 + hr, h)), slice(max(iw0, 0), min(iw0 + hc, w))
                halo[:, ys.start - ih0:ys.stop - ih0, xs.start - iw0:xs.stop - iw0] = \
                    xq[img, :, ys, xs]
                tr, tcol = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
                a = torch.zeros((rows * cols, tk.BLOCK_K), dtype=torch.float64)  # (ci, r, c)
                a[:, :k] = halo[ci[None], tr.reshape(-1, 1) * stride + r[None],
                                tcol.reshape(-1, 1) * stride + c[None]].to(torch.float64)
                acc = (a @ weights.T).to(torch.int32).T.reshape(cout, rows, cols)
                y = tk.epilogue(acc, mul, add, out_dtype)
                nr, nc = min(rows, ho - oh0), min(cols, wo - ow0)
                out[img, :, oh0:oh0 + nr, ow0:ow0 + nc] = y[:, :nr, :nc]
    return out


@pytest.mark.parametrize("stride,hw", [(2, (23, 38)), (1, (9, 37)), (2, (6, 1100))])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.int8),
    (torch.int8, torch.float32)])
def test_stem_emulation_equals_plain_and_jax(stride, hw, in_dtype, out_dtype):
    rng = np.random.default_rng(stride * 100 + hw[1])
    h, w = hw
    cout = 40
    wq = torch.as_tensor(rng.integers(-127, 128, size=(cout, 3, 3, 3)).astype(np.int8))
    inv = torch.tensor([127.0 / 6.0])
    if in_dtype == torch.int8:
        x = torch.as_tensor(rng.integers(-127, 128, size=(2, 3, h, w)).astype(np.int8))
    else:
        x = torch.as_tensor(rng.standard_normal((2, 3, h, w)).astype(np.float32) * 3).to(in_dtype)
        x[1, 2, h - 1, w // 2] = float("nan")  # quantizes to 0
    mul = torch.as_tensor(rng.uniform(0.5, 1.5, size=cout).astype(np.float32)) * 2e-4
    add = torch.as_tensor(rng.standard_normal(cout).astype(np.float32))
    if out_dtype == torch.int8:
        mul, add = mul * 1e3, add * 10
    assert tk.stem_path(3, 3, 3) and not tk.stem_path(48, 3, 3) and not tk.stem_path(5, 3, 3)
    got = _stem_emulation(x, tk.pack_weight(wq), inv, mul, add, out_dtype, 3, 3, stride)
    ref = tk.int8_conv_plain(x, wq, inv, mul, add, out_dtype, stride)
    assert torch.equal(got, ref)
    # the int32 sums against the JAX package's conv of the same codes
    xq = x if in_dtype == torch.int8 else tk.quantize_input(x, inv)
    acc_j = np.asarray(jq._int8_conv(jnp.asarray(xq.permute(0, 2, 3, 1).numpy()),
                                     jnp.asarray(wq.permute(2, 3, 1, 0).numpy()), stride))
    acc_t = tk.conv_exact(xq, wq, stride)
    np.testing.assert_array_equal(acc_t.permute(0, 2, 3, 1).numpy(), acc_j)


def _stem_nhwc_emulation(x, wk, inv, mul, add, out_dtype, kh, kw, stride):
    """The stem kernel's NHWC mode on channels-last x, block by block of
    `stem_tile` pixels, with its flat index arithmetic."""
    n, cin, h, w = x.shape
    e = 16 // x.element_size()  # input elements a 16-byte chunk
    ph, pw = kh // 2, kw // 2
    ho, wo = tk.out_size(h, kh, stride), tk.out_size(w, kw, stride)
    rows, cols = tk.stem_tile(ho, wo)
    cout = mul.shape[0]
    k = cin * kh * kw
    xq = x if x.dtype == torch.int8 else tk.quantize_input(x, inv)
    flat = xq.permute(0, 2, 3, 1).reshape(n, h, w * cin)  # NHWC input rows
    ci, r, c = (torch.as_tensor(v) for v in np.unravel_index(np.arange(k), (cin, kh, kw)))
    weights = wk[:cout, :tk.BLOCK_K].to(torch.float64)
    halo_rows = (rows - 1) * stride + kh
    halo_elems = ((cols - 1) * stride + kw) * cin
    halo_stride = (halo_elems + 2 * e - 2) // e * e
    off = r * halo_stride + c * cin + ci
    tr, tcol = (torch.as_tensor(v.reshape(-1)) for v in np.meshgrid(
        np.arange(rows), np.arange(cols), indexing="ij"))
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype)
    for img in range(n):
        for oh0 in range(0, ho, rows):
            for ow0 in range(0, wo, cols):
                ih0, iw0 = oh0 * stride - ph, ow0 * stride - pw
                row_start = iw0 * cin
                c_first = row_start // e * e  # floor: the chunk at or below
                halo = torch.zeros((halo_rows, halo_stride), dtype=torch.int8)
                for i in range(halo_rows):
                    if 0 <= ih0 + i < h:
                        gc = c_first + torch.arange(halo_stride)
                        ok = (gc >= 0) & (gc < w * cin)
                        halo[i, ok] = flat[img, ih0 + i, gc[ok]]
                base = tr * stride * halo_stride + tcol * stride * cin + (row_start - c_first)
                a = torch.zeros((rows * cols, tk.BLOCK_K), dtype=torch.float64)
                a[:, :k] = halo.reshape(-1)[base[:, None] + off[None]].to(torch.float64)
                acc = (a @ weights.T).to(torch.int32).T.reshape(cout, rows, cols)
                y = tk.epilogue(acc, mul, add, out_dtype).permute(1, 2, 0)
                nr, nc = min(rows, ho - oh0), min(cols, wo - ow0)
                out[img, oh0:oh0 + nr, ow0:ow0 + nc] = y[:nr, :nc]
    return out.permute(0, 3, 1, 2)


@pytest.mark.parametrize("stride,hw", [(2, (23, 38)), (1, (9, 37)), (2, (6, 1100)),
                                       (1, (5, 64))])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.int8),
    (torch.int8, torch.float32)])
def test_stem_nhwc_emulation_equals_plain(stride, hw, in_dtype, out_dtype):
    rng = np.random.default_rng(stride * 10 + hw[1])
    h, w = hw
    cout = 40
    wq = torch.as_tensor(rng.integers(-127, 128, size=(cout, 3, 3, 3)).astype(np.int8))
    inv = torch.tensor([127.0 / 6.0])
    if in_dtype == torch.int8:
        x = torch.as_tensor(rng.integers(-127, 128, size=(2, 3, h, w)).astype(np.int8))
    else:
        x = torch.as_tensor(rng.standard_normal((2, 3, h, w)).astype(np.float32) * 3).to(in_dtype)
        x[1, 2, h - 1, w // 2] = float("nan")  # quantizes to 0
    x = x.contiguous(memory_format=torch.channels_last)
    mul = torch.as_tensor(rng.uniform(0.5, 1.5, size=cout).astype(np.float32)) * 2e-4
    add = torch.as_tensor(rng.standard_normal(cout).astype(np.float32))
    if out_dtype == torch.int8:
        mul, add = mul * 1e3, add * 10
    got = _stem_nhwc_emulation(x, tk.pack_weight(wq), inv, mul, add, out_dtype, 3, 3, stride)
    ref = tk.int8_conv_plain(x, wq, inv, mul, add, out_dtype, stride)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert ref.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref)


def test_stem_tile_covers_the_main_path_stems():
    assert tk.stem_tile(192, 144) == (1, 144)  # HRNet-W48's stem, 384x288 stride 2
    assert tk.stem_tile(416, 416) == (1, 416)  # YOLOv3-416's stem, stride 1
    for ho, wo in ((1, 1), (5, 17), (300, 255), (7, 1000), (3, 1100)):
        rows, cols = tk.stem_tile(ho, wo)
        assert cols % 16 == 0 and 16 <= cols <= 512 and 1 <= rows <= ho
        assert -(-wo // cols) * cols - wo < 16 * -(-wo // 512)  # runs of near-equal width
