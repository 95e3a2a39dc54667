"""tpupose_torch.models.quantize against tpupose.models.quantize: the int8
quantization math, the plain version of kernel K2, calibration, the
quantized module tree and its state_dict, and the int8-resident blocks.

Inputs are made with numpy from a seed and given to both packages; float
weights cross over through `models/convert.py`.

Tolerances and why:
* Quantized weights, weight and activation scales, int32 conv outputs and
  requantized int8 tensors are bit-equal: both packages run the same IEEE
  f32 operations in the same order, and the int32 conv is exact.
* The dequantized conv output is equal in bf16 and within 1 ulp in f32 (the
  product and the bias add round separately on both sides; XLA may still
  fuse them).
* Calibrated activation ranges agree within rtol 1e-5 in f32: the two
  libraries' f32 convolutions sum in different orders.
* A whole int8 network in f32 agrees within 1e-6 of its largest output: the
  float head (`final_layer`) sums in another order, and that difference
  can move one int8 code nowhere upstream of it.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpupose.models.hrnet as jh
import tpupose.models.layers as jl
import tpupose.models.quantize as jq
import tpupose.models.yolov3 as jy
import tpupose_torch.models.hrnet as th
import tpupose_torch.models.layers as tl
import tpupose_torch.models.quantize as tq
import tpupose_torch.models.yolov3 as ty
import tpupose_torch.ops.int8_conv as tk
from tpupose_torch.models.convert import state_dict_from_jax

torch.set_num_threads(1)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _conv_paths(tree, prefix=""):
    """id(conv dict) -> dotted path, for every dict with a 4-D weight."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            if np.ndim(value.get("weight")) == 4:
                out[id(value)] = name
            else:
                out.update(_conv_paths(value, name))
    return out


def _conv_pair(rng, cin, cout, k, bias=True, stride=1):
    """A JAX conv dict and the port's Conv2d with the same weights."""
    w = (rng.standard_normal((k, k, cin, cout)) * 0.3).astype(np.float32)
    w[..., 0] *= 4.0  # one channel with a wider range
    p = {"weight": jnp.asarray(w)}
    conv = tl.Conv2d(cin, cout, k, stride=stride, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(w.transpose(3, 2, 0, 1).copy()))
        if bias:
            b = (rng.standard_normal(cout) * 0.2).astype(np.float32)
            p["bias"] = jnp.asarray(b)
            conv.bias.copy_(torch.as_tensor(b))
    return p, conv


SHAPES = {  # name: (cin, cout, k, stride, dilation)
    "1x1_s1": (16, 24, 1, 1, 1),
    "3x3_s1": (8, 16, 3, 1, 1),
    "3x3_s2": (8, 16, 3, 2, 1),
    "cin3": (3, 16, 3, 2, 1),
    "cout17": (16, 17, 1, 1, 1),
    "dilation2": (8, 8, 3, 1, 2),
}


@pytest.mark.parametrize("weight_mse", [False, True])
def test_quantize_convs_bit_equal_to_jax(weight_mse):
    rng = np.random.default_rng(0)
    tree, convs, scales_j, scales_t = {}, {}, {}, {}
    for i, (cin, cout, k, stride, _) in enumerate(SHAPES.values()):
        p, conv = _conv_pair(rng, cin, cout, k, bias=i % 2 == 0, stride=stride)
        tree[f"c{i}"], convs[f"c{i}"] = p, conv
        absmax = float(rng.uniform(0.5, 30.0))
        scales_j[id(p)], scales_t[conv] = absmax, absmax
    qj = jq.quantize_convs(tree, scales_j, weight_mse=weight_mse)
    model = torch.nn.ModuleDict(convs)
    qt = tq.quantize_convs(model, scales_t, weight_mse=weight_mse)
    for name in tree:
        got, ref = qt[name], qj[name]
        assert isinstance(got, tl.QuantConv2d) and got.weight_q.dtype == torch.int8
        np.testing.assert_array_equal(got.weight_q.numpy(),
                                      np.asarray(ref["weight_q"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got.w_scale.numpy(), np.asarray(ref["w_scale"]))
        np.testing.assert_array_equal(got.x_scale.numpy(), np.asarray(ref["x_scale"]))
        assert got.x_scale.dtype == torch.float32 and got.x_scale.dim() == 0
        assert ("bias" in ref) == (got.bias is not None)


def _quant_pair(rng, cin, cout, k, stride=1, dilation=1, absmax=4.0):
    p, conv = _conv_pair(rng, cin, cout, k, stride=stride)
    conv.dilation = (dilation, dilation)
    qj = jq.quantize_convs({"c": p}, {id(p): absmax})["c"]
    qt = tq.quantize_convs(torch.nn.ModuleDict({"c": conv}), {conv: absmax})["c"]
    return qj, qt


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_int8_conv_exact_and_apply_match_jax(shape):
    cin, cout, k, stride, dil = SHAPES[shape]
    rng = np.random.default_rng(1)
    qj, qt = _quant_pair(rng, cin, cout, k, stride, dil)
    x = rng.standard_normal((2, 11, 9, cin)).astype(np.float32) * 2.0
    x[1, 5, 4, 0] = np.nan  # XLA converts it to the int8 code 0
    xq = np.asarray(jq._quant_input(qj, jnp.asarray(x)))
    got_q = tk.quantize_input(_nchw(x), qt.inv_scale())
    np.testing.assert_array_equal(_nhwc(got_q), xq)
    assert xq[1, 5, 4, 0] == 0

    ref = np.asarray(jq._int8_conv(jnp.asarray(xq), qj["weight_q"], stride, dilation=dil))
    got = tk.conv_exact(got_q, qt.weight_q, stride, dil)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(got), ref)
    assert np.abs(ref).max() > 127  # a real sum, not a copy

    ref32 = np.asarray(jq.quantized_conv_apply(qj, jnp.asarray(x), stride, dilation=dil))
    got32 = _nhwc(qt(_nchw(x)))
    assert got32.dtype == np.float32
    np.testing.assert_array_max_ulp(got32, ref32, maxulp=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    refb = np.asarray(jq.quantized_conv_apply(qj, xb, stride, dilation=dil).astype(jnp.float32))
    gotb = qt(_nchw(x).to(torch.bfloat16))
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(gotb.float()), refb)


def test_requant_relu_bit_equal():
    rng = np.random.default_rng(2)
    qj1, qt1 = _quant_pair(rng, 8, 16, 3, absmax=3.0)
    qj2, qt2 = _quant_pair(rng, 16, 8, 3, absmax=5.0)
    y32 = rng.integers(-20000, 20000, size=(2, 7, 5, 16)).astype(np.int32)
    ref = np.asarray(jq._requant_relu(jnp.asarray(y32), qj1, qj2))
    got = tk.epilogue(_nchw(y32), *tq.requant_vectors(qt1, qt2), torch.int8)
    assert got.dtype == torch.int8 and ref.min() == 0 and ref.max() == 127
    np.testing.assert_array_equal(_nhwc(got), ref)


def _folded_block(block_j, block_t, scales):
    """Quantize a folded JAX block dict and carry it into the port's block
    (folded, quantized by `quantize_convs`, then loaded strictly)."""
    qj = jq.quantize_convs(block_j, {id(block_j[c]): s for c, s in scales.items()})
    tl.fold_batchnorm(block_t)
    block_t.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, block_j)))
    convs = {getattr(block_t, c): s for c, s in scales.items()}
    qt = tq.quantize_convs(block_t, convs)
    qt.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, qj)), strict=True)
    return qj, qt


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_resident_blocks_equal_jax(kind):
    rng = np.random.default_rng(3)
    c = 8
    if kind == "basic":
        block_t = th.BasicBlock(c, c)
        convs = {"conv1": (c, c, 3), "conv2": (c, c, 3)}
        fn_j, fn_t = jq.quantized_basic_block, tq.quantized_basic_block
    else:
        block_t = th.Bottleneck(4 * c, c)
        convs = {"conv1": (4 * c, c, 1), "conv2": (c, c, 3), "conv3": (c, 4 * c, 1)}
        fn_j, fn_t = jq.quantized_bottleneck, tq.quantized_bottleneck
    block_j = {name: {"weight": jnp.asarray(rng.standard_normal((k, k, ci, co)) * 0.2,
                                            jnp.float32),
                      "bias": jnp.asarray(rng.standard_normal(co) * 0.1, jnp.float32)}
               for name, (ci, co, k) in convs.items()}
    for i in range(len(convs)):
        block_j[f"bn{i + 1}"] = {}
    scales = {name: float(rng.uniform(2.0, 4.0)) for name in convs}
    qj, qt = _folded_block(block_j, block_t, scales)
    cin = convs["conv1"][0]
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(fn_j(qj, jnp.asarray(x, dt_j)).astype(jnp.float32))
        with torch.no_grad():
            got = fn_t(qt, _nchw(x).to(dt_t))
            dispatched = qt(_nchw(x).to(dt_t), resident=True)
        assert got.dtype == dt_t
        np.testing.assert_array_equal(_nhwc(got.float()), ref)
        torch.testing.assert_close(dispatched, got, rtol=0, atol=0)
        assert (ref >= 0).all() and ref.max() > 0


def _tiny_hrnet(seed=1):
    cfg = jh.tiny_test_config()
    params = jl.fold_batchnorm(jh.hrnet_init(jax.random.PRNGKey(seed), cfg))
    model = tl.fold_batchnorm(th.HRNet(th.tiny_test_config()))
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return cfg, params, model


def _tiny_yolo(seed=0):
    cfg = jy.tiny_yolo_test_config()
    params = jl.fold_batchnorm(jy.yolov3_init(jax.random.PRNGKey(seed), cfg))
    model = tl.fold_batchnorm(ty.YOLOv3(ty.tiny_yolo_test_config()))
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return cfg, params, model


def _net(name):
    rng = np.random.default_rng(4)
    if name == "hrnet":
        cfg, params, model = _tiny_hrnet()
        x = rng.normal(size=(2, *cfg.input_size, 3)).astype(np.float32)
        apply_j = lambda b: jh.hrnet_apply(params, cfg, b, compute_dtype=jnp.float32)
        skip_j, skip_t = jq.hrnet_skip_ids(params), tq.hrnet_skip_ids(model)
    else:
        cfg, params, model = _tiny_yolo()
        x = rng.uniform(size=(2, cfg.input_size, cfg.input_size, 3)).astype(np.float32)
        apply_j = lambda b: jy.yolov3_apply(params, cfg, b, compute_dtype=jnp.float32)
        skip_j, skip_t = jq.yolo_skip_ids(params, cfg), tq.yolo_skip_ids(model, cfg)
    return cfg, params, model, x, apply_j, skip_j, skip_t


@pytest.mark.parametrize("percentile", [None, 99.9])
@pytest.mark.parametrize("net", ["hrnet", "yolo"])
def test_calibrate_matches_jax(net, percentile):
    cfg, params, model, x, apply_j, skip_j, skip_t = _net(net)
    sj = jq.calibrate(apply_j, jnp.asarray(x), percentile=percentile)
    st = tq.calibrate(lambda b: model(b, torch.float32), _nchw(x), percentile=percentile)
    paths = _conv_paths(params)
    names = {m: n for n, m in model.named_modules()}
    vj = {paths[k]: v for k, v in sj.items()}
    vt = {names[m]: v for m, v in st.items()}
    assert set(vt) == set(vj) and len(vt) > 30
    for name, v in vj.items():
        np.testing.assert_allclose(vt[name], v, rtol=1e-5, err_msg=name)
    assert {paths[i] for i in skip_j} == {names[m] for m in skip_t}
    if net == "yolo":
        assert tq.yolo_detection_head_names(cfg) == jq.yolo_detection_head_names(cfg)


def test_per_channel_percentile_and_quantile_match_jax():
    rng = np.random.default_rng(5)
    a = np.abs(rng.standard_normal((6, 1001))).astype(np.float32)
    for q in (0.5, 0.999, 0.9999, 1.0):
        ref = np.asarray(jnp.quantile(jnp.asarray(a), q, axis=1))
        np.testing.assert_array_equal(tl.quantile_linear(torch.as_tensor(a), q).numpy(), ref)
    cfg, params, model, x, apply_j, _, _ = _net("hrnet")
    sj = jq.calibrate(apply_j, jnp.asarray(x), percentile=99.0, per_channel=True)
    st = tq.calibrate(lambda b: model(b, torch.float32), _nchw(x), percentile=99.0,
                      per_channel=True)
    paths = _conv_paths(params)
    vj = {paths[k]: v for k, v in sj.items()}
    for m, v in st.items():
        name = next(n for n, mod in model.named_modules() if mod is m)
        assert v.shape == vj[name].shape
        np.testing.assert_allclose(v, vj[name], rtol=1e-5, atol=1e-7)


def test_quantize_leaves_float_model_and_loads_jax_tree():
    cfg, params, model, x, apply_j, skip_j, skip_t = _net("hrnet")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qt = tq.quantize_hrnet(model, th.tiny_test_config(), _nchw(x),
                           compute_dtype=torch.float32)
    after = model.state_dict()
    assert before.keys() == after.keys()
    for k in before:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
    assert not any(isinstance(m, tl.QuantConv2d) for m in model.modules())
    n_quant = sum(isinstance(m, tl.QuantConv2d) for m in qt.modules())
    assert n_quant == sum(isinstance(m, tl.Conv2d) for m in model.modules()) - 1
    assert isinstance(qt.final_layer, tl.Conv2d)

    # a tree quantized by the JAX package loads strictly into the module
    # quantize_convs builds for the same skip set, and runs like it
    qj = jq.quantize_hrnet(params, cfg, jnp.asarray(x))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, qj))
    assert sd["layer1.0.conv1.weight_q"].dtype == torch.int8
    shell = tq.quantize_convs(model, tq.uncalibrated_scales(model, skip_t), skip_t)
    shell.load_state_dict(sd, strict=True)
    assert set(shell.state_dict()) == set(sd)
    ref = np.asarray(jh.hrnet_apply(qj, cfg, jnp.asarray(x), compute_dtype=jnp.float32))
    with torch.no_grad():
        got = _nhwc(shell(_nchw(x), torch.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    # equalize=True (cross-layer equalization first) stays in the PTQ error
    # band of the JAX package's test, and leaves the float model as it was
    qe = tq.quantize_hrnet(model, th.tiny_test_config(), _nchw(x), equalize=True,
                           compute_dtype=torch.float32)
    with torch.no_grad():
        hf = model(_nchw(x), torch.float32).numpy()
        he = qe(_nchw(x), torch.float32).numpy()
    assert np.median(np.abs(hf - he)) / (hf.max() - hf.min()) < 0.02
    assert not torch.equal(qe.layer1[0].conv2.weight_q, qt.layer1[0].conv2.weight_q)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_resident_dispatch_in_hrnet(monkeypatch):
    cfg, params, model, x, _, _, skip_t = _net("hrnet")
    qt = tq.quantize_convs(model, tq.uncalibrated_scales(model, skip_t), skip_t)
    qt.load_state_dict(state_dict_from_jax(jax.tree.map(
        np.asarray, jq.quantize_hrnet(params, cfg, jnp.asarray(x)))), strict=True)
    rcfg = dataclasses.replace(cfg, int8_resident=True)
    ref = np.asarray(jh.hrnet_apply(jq.quantize_hrnet(params, cfg, jnp.asarray(x)), rcfg,
                                    jnp.asarray(x), compute_dtype=jnp.float32))
    calls = {"basic": 0, "bottleneck": 0}
    for kind, name in (("basic", "quantized_basic_block"), ("bottleneck", "quantized_bottleneck")):
        orig = getattr(tq, name)

        def counted(block, v, orig=orig, kind=kind):
            calls[kind] += 1
            return orig(block, v)
        monkeypatch.setattr(tq, name, counted)
    qt.cfg = dataclasses.replace(qt.cfg, int8_resident=True)
    with torch.no_grad():
        got = _nhwc(qt(_nchw(x), torch.float32))
    n_basic = sum(isinstance(m, th.BasicBlock) for m in qt.modules())
    assert calls == {"basic": n_basic, "bottleneck": cfg.layer1_blocks} and n_basic > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    # width-packed branch 0 takes the same resident blocks, with the same
    # int32 sums: the output is equal
    from tpupose_torch.ops.packing import pack_hrnet_branch0

    calls.update(basic=0, bottleneck=0)
    with torch.no_grad():
        packed = _nhwc(pack_hrnet_branch0(qt)(_nchw(x), torch.float32))
    assert calls == {"basic": n_basic, "bottleneck": cfg.layer1_blocks}
    np.testing.assert_array_equal(packed, got)


def test_int8_conv_dispatch_keeps_cpu_tensors_on_the_plain_version(monkeypatch):
    from tpupose_torch import kernels

    def no_kernel(name):
        raise AssertionError("the CUDA kernel must not be reached from a CPU tensor")

    monkeypatch.setattr(kernels, "library", no_kernel)
    rng = np.random.default_rng(6)
    _, qt = _quant_pair(rng, 5, 70, 3)
    x = _nchw(rng.standard_normal((1, 6, 7, 5)).astype(np.float32))
    before = tk.launches
    mul, add = qt.dequant_vectors()
    got = tk.int8_conv(x, qt.weight_q, qt.weight_k, qt.inv_scale(), mul, add, torch.float32)
    torch.testing.assert_close(got, tk.int8_conv_plain(x, qt.weight_q, qt.inv_scale(), mul, add,
                                                       torch.float32), rtol=0, atol=0)
    torch.testing.assert_close(qt(x), got, rtol=0, atol=0)
    assert tk.launches == before
    # the kernel's weight operand: rows of weight_q in (ci, kh, kw) order,
    # Cout padded to 64 and K to 32 with zeros
    assert qt.weight_k.shape == (128, 64) and qt.weight_k.dtype == torch.int8
    np.testing.assert_array_equal(qt.weight_k[:70, :45].numpy(),
                                  qt.weight_q.reshape(70, 45).numpy())
    assert not qt.weight_k[70:].any() and not qt.weight_k[:, 45:].any()
    assert "weight_k" not in qt.state_dict()
    with pytest.raises(ValueError, match="CUDA"):
        tk.int8_conv_cuda(x, qt.weight_k, (3, 3), qt.inv_scale(), mul, add, torch.float32)
    if not torch.cuda.is_available():
        from tpupose_torch.pipeline import resolve_device

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
