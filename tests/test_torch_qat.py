"""Distill-QAT and the further PTQ options of `tpupose_torch.models.quantize`
against `tpupose.models.quantize`, on the tiny configs.

Inputs are made with numpy from a seed and given to both packages; weights
cross over through `models/convert.py`. Everything runs in f32.

Tolerances and why:
* `_ste_qdq` / `_lsq_qdq` values and gradients: rtol 1e-5. Both packages
  run the same f32 operations; at exactly +-127 both clips pass half the
  gradient (max then min with tensor bounds, as `jnp.clip`).
* One fake-quant conv, output and gradients: rtol 1e-4 with an absolute
  floor of 1e-5 of the largest value: the f32 convolutions and their
  gradients sum in another order.
* `requantize_after_qat` from one fake-quant tree: bit-equal (the JAX
  weight-scale formula, XLA's reciprocal of 127 included).
* `distill_qat` on a model two quantized convs deep, 6 Adam steps: losses,
  activation scales and trained float weights within rtol 1e-3, at most
  0.1% of `weight_q` different. The calibrated ranges agree within rtol
  1e-5 (tests/test_torch_quantize.py), and the forward and backward sums
  differ in order. On the whole tiny networks an int8 code flip spreads
  (see that test), so there the 3-step bound is Adam's own, 6.1 lr, a
  sanity check; the gradients are held per fake-quant conv instead.
* The first QAT step's gradients on the tiny networks, each fake-quant
  conv at its own input and output gradient against `jax.vjp`: relative
  norm within 1e-5 for weight, bias and input gradients and 2e-2 for
  `fq_x_scale` (`GRAD_LIMITS`, from measured readings).
* `equalize_convs` from the same per-channel ranges: the same pairs, and
  weights within rtol 1e-6 (`pow` may differ in the last bit).
* `calibrate_mse`: the grid index per conv is exactly equal; it is an argmin
  over errors that differ by far more than the summation-order noise.
* `bias_correct_convs` from the same means: biases within rtol 1e-5 and
  1e-6 of the largest bias (the einsums sum in another order); the
  recorded means within 1e-5 of their largest value.
* `calibrate_bn_stats`: running statistics within rtol 1e-5, and for means
  near 0 within 1e-5 of the largest value (HRNet) or 5e-5 (YOLO, whose BNs
  sit up to 75 layers deep, each adding its own f32 summation noise).
"""
import dataclasses
import functools

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
from tpupose_torch.models.convert import state_dict_from_jax

torch.set_num_threads(1)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


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


def _sd(tree):
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


def _close(got, ref, rtol, floor, msg=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=floor * float(np.abs(ref).max()), err_msg=msg)


def _net(name, fold=True, bn_stats=True):
    """(cfg, JAX tree, port module, NHWC input, JAX f32 apply(p, x), port
    f32 apply(m, x), JAX skip ids, port skip set). HRNet's BN statistics
    are first re-estimated on the input by the JAX package, so activations
    are O(1) as in a trained network."""
    rng = np.random.default_rng(7)
    if name == "hrnet":
        cfg = jh.tiny_test_config()
        raw = jh.hrnet_init(jax.random.PRNGKey(3), cfg)
        x = rng.random((2, *cfg.input_size, 3)).astype(np.float32)
        apply_j = lambda p, b: jh.hrnet_apply(p, cfg, b, compute_dtype=jnp.float32)  # noqa: E731
        if bn_stats:
            jq.calibrate_bn_stats(lambda b: apply_j(raw, b), jnp.asarray(x))
        module = th.HRNet(th.tiny_test_config())
    else:
        cfg = jy.tiny_yolo_test_config()
        raw = jy.yolov3_init(jax.random.PRNGKey(4), cfg)
        x = rng.random((2, cfg.input_size, cfg.input_size, 3)).astype(np.float32)
        apply_j = lambda p, b: jy.yolov3_apply(p, cfg, b, compute_dtype=jnp.float32)  # noqa: E731
        module = ty.YOLOv3(ty.tiny_yolo_test_config())
    params = jl.fold_batchnorm(raw) if fold else raw
    if fold:
        tl.fold_batchnorm(module)
    module.load_state_dict(_sd(params), strict=True)
    if name == "hrnet":
        skip_j, skip_t = jq.hrnet_skip_ids(params), tq.hrnet_skip_ids(module)
    else:
        skip_j, skip_t = jq.yolo_skip_ids(params, cfg), tq.yolo_skip_ids(module, cfg)
    return (cfg, params, module, x, apply_j, lambda m, b: m(b, torch.float32),
            skip_j, skip_t)


def _by_name(scales_j, params, module):
    """A dict keyed by JAX conv-dict id as one keyed by the port's module."""
    paths = _conv_paths(params)
    return {module.get_submodule(paths[k]): v for k, v in scales_j.items()}


# -- the quantize-dequantize estimators ----------------------------------------------

@pytest.mark.parametrize("fn", ["_ste_qdq", "_lsq_qdq"])
def test_qdq_values_and_gradients_match_jax(fn):
    s = np.float32(0.037)
    rng = np.random.default_rng(0)
    codes = np.array([-300.0, -128.0, -127.5, -127.0, -126.5, -0.3, 0.0, 0.5, 1.5,
                      126.4, 126.5, 127.0, 127.5, 128.0, 300.0], np.float32)
    t = np.concatenate([codes * s, rng.standard_normal(200).astype(np.float32) * 3])
    c = rng.standard_normal(t.shape).astype(np.float32)
    jfn = getattr(jq, fn)
    ref = np.asarray(jfn(jnp.asarray(t), jnp.asarray(s)))
    gt, gs = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * c), argnums=(0, 1))(
        jnp.asarray(t), jnp.asarray(s))
    tt = torch.tensor(t, requires_grad=True)
    st = torch.tensor(s, requires_grad=True)
    got = getattr(tq, fn)(tt, st)
    (got * torch.as_tensor(c)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=1e-5, atol=0)
    # the STE's scale sits only in the detached branch: no gradient (JAX: 0)
    g_s = 0.0 if st.grad is None else float(st.grad)
    np.testing.assert_allclose(g_s, float(gs), rtol=1e-5, atol=1e-7)
    if fn == "_lsq_qdq":
        # the clip passes half the gradient at exactly +-127 codes, none beyond
        on = np.abs(np.abs(t / s) - 127.0) < 1e-3
        assert on.any() and np.allclose(np.asarray(gt)[on], 0.5 * c[on])
        assert np.all(np.asarray(gt)[np.abs(t / s) > 127.6] == 0)
        assert float(gs) != 0.0


FQ_SHAPES = {  # name: (cin, cout, k, stride, bias)
    "1x1_bias": (8, 12, 1, 1, True),
    "3x3_s2": (6, 10, 3, 2, False),
    "3x3_bias": (5, 7, 3, 1, True),
}


@pytest.mark.parametrize("shape", sorted(FQ_SHAPES))
def test_fake_quant_conv_apply_matches_jax(shape):
    cin, cout, k, stride, bias = FQ_SHAPES[shape]
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.3).astype(np.float32)
    s = np.float32(0.05)
    x = (rng.standard_normal((2, 9, 11, cin)) * 2.0).astype(np.float32)
    x[0, 0, :3, 0] = np.array([127.0, -127.0, 140.0], np.float32) * s  # on and past the clip
    p = {"weight": jnp.asarray(w), "fq_x_scale": jnp.asarray(s)}
    conv = tl.Conv2d(cin, cout, k, stride=stride, bias=bias)
    if bias:
        b = (rng.standard_normal(cout) * 0.2).astype(np.float32)
        p["bias"] = jnp.asarray(b)
    fq = tq.fake_quant_convs(torch.nn.ModuleDict({"c": conv}), {conv: 1.0})["c"]
    assert isinstance(fq, tl.FakeQuantConv2d)
    fq.load_state_dict(_sd(p), strict=True)

    def f(params, xx):
        return jq.fake_quant_conv_apply(params, xx, stride=stride)

    ref = np.asarray(f(p, jnp.asarray(x)))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    gp, gx = jax.grad(lambda pp, xx: jnp.sum(f(pp, xx) * cot), argnums=(0, 1))(p, jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    out = fq(xt)
    (out * _nchw(cot)).sum().backward()
    _close(out.detach().permute(0, 2, 3, 1).numpy(), ref, 1e-4, 1e-5, "output")
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, 1e-4, 1e-5, "input grad")
    _close(fq.weight.grad.permute(2, 3, 1, 0).numpy(), gp["weight"], 1e-4, 1e-5, "weight grad")
    _close(float(fq.fq_x_scale.grad), gp["fq_x_scale"], 1e-4, 0, "fq_x_scale grad")
    if bias:
        _close(fq.bias.grad.numpy(), gp["bias"], 1e-4, 1e-5, "bias grad")
    assert float(gp["fq_x_scale"]) != 0.0


# -- requantization and QAT ------------------------------------------------------

def _perturbed_fq_tree(params, scales, skip, seed):
    """The JAX fake-quant tree with every float leaf moved a little, as a
    few training steps would."""
    rng = np.random.default_rng(seed)
    fq = jq.fake_quant_convs(params, scales, skip)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) * (1 + 0.01 * rng.standard_normal(np.shape(a)))
                              .astype(np.float32)), fq)


@pytest.mark.parametrize("net", ["hrnet", "yolo"])
def test_requantize_after_qat_equal_to_jax_from_one_tree(net):
    cfg, params, model, x, apply_j, _, skip_j, skip_t = _net(net)
    scales = jq.calibrate(lambda b: apply_j(params, b), jnp.asarray(x))
    fq_j = _perturbed_fq_tree(params, scales, skip_j, seed=2)
    # the JAX fake-quant tree loads strictly into the module fake_quant_convs builds
    fq_t = tq.fake_quant_convs(model, tq.uncalibrated_scales(model, skip_t), skip_t)
    fq_t.load_state_dict(_sd(fq_j), strict=True)
    assert set(fq_t.state_dict()) == set(_sd(fq_j))
    ref = _sd(jq.requantize_after_qat(fq_j))
    got = tq.requantize_after_qat(fq_t)
    assert not any(isinstance(m, tl.FakeQuantConv2d) for m in got.modules())
    sd = got.state_dict()
    assert set(sd) == set(ref) and any(k.endswith("weight_q") for k in ref)
    for k in ref:
        assert sd[k].dtype == ref[k].dtype and torch.equal(sd[k], ref[k]), k
    # the fake-quant model is left as it was
    assert any(isinstance(m, tl.FakeQuantConv2d) for m in fq_t.modules())


def test_fake_quant_hrnet_is_never_fused_as_int8_resident(monkeypatch):
    _, params, model, x, _, _, _, skip_t = _net("hrnet", bn_stats=False)
    fq = tq.fake_quant_convs(model, tq.uncalibrated_scales(model, skip_t), skip_t)

    def refuse(*args):
        raise AssertionError("a fake-quant block must not take the int8-resident path")

    monkeypatch.setattr(tq, "quantized_basic_block", refuse)
    monkeypatch.setattr(tq, "quantized_bottleneck", refuse)
    with torch.no_grad():
        generic = fq(_nchw(x), torch.float32)
        fq.cfg = dataclasses.replace(fq.cfg, int8_resident=True)
        resident = fq(_nchw(x), torch.float32)
    torch.testing.assert_close(resident, generic, rtol=0, atol=0)


class _Toy(torch.nn.Module):
    """conv (bias) -> relu -> stride-2 conv -> relu -> two heads, one of them
    kept float: the shape of a distillation with several outputs and a
    skipped head, two quantized convs deep."""

    def __init__(self):
        super().__init__()
        self.c1 = tl.Conv2d(3, 8, 3, bias=True)
        self.c2 = tl.Conv2d(8, 16, 3, stride=2)
        self.h1 = tl.Conv2d(16, 5, 1, bias=True)
        self.h2 = tl.Conv2d(16, 4, 1)

    def forward(self, x, compute_dtype=torch.float32):
        y = torch.relu(self.c2(torch.relu(self.c1(x.to(compute_dtype)))))
        return [self.h1(y), self.h2(y)]


def _toy_apply_j(p, x):
    y = jax.nn.relu(jl.conv_apply(p["c2"], jax.nn.relu(jl.conv_apply(p["c1"], x)), stride=2))
    return [jl.conv_apply(p["h1"], y), jl.conv_apply(p["h2"], y)]


def test_distill_qat_matches_jax_on_a_small_model():
    rng = np.random.default_rng(9)
    params = {name: {"weight": jnp.asarray(rng.standard_normal(shape) * 0.3, jnp.float32)}
              for name, shape in (("c1", (3, 3, 3, 8)), ("c2", (3, 3, 8, 16)),
                                  ("h1", (1, 1, 16, 5)), ("h2", (1, 1, 16, 4)))}
    for name, c in (("c1", 8), ("h1", 5)):
        params[name]["bias"] = jnp.asarray(rng.standard_normal(c) * 0.1, jnp.float32)
    model = _Toy()
    model.load_state_dict(_sd(params), strict=True)
    xs = [rng.random((2, 12, 10, 3)).astype(np.float32) for _ in range(2)]
    lr, steps, logs_j, logs_t = 1e-4, 6, [], []
    q_j = jq.distill_qat(_toy_apply_j, params, None, [jnp.asarray(x) for x in xs], steps=steps,
                         lr=lr, skip_ids={id(params["h1"])}, log=lambda i, v: logs_j.append(v))
    q_t = tq.distill_qat(lambda m, b: m(b), model, [_nchw(x) for x in xs], steps=steps, lr=lr,
                         skip_ids={model.h1}, log=lambda i, v: logs_t.append(v))
    assert len(logs_t) == len(logs_j) == steps
    np.testing.assert_allclose(logs_t, logs_j, rtol=1e-3)
    ref, got = _sd(q_j), q_t.state_dict()
    assert set(got) == set(ref) and isinstance(q_t.h1, tl.Conv2d)
    for k in ref:
        if k.endswith("weight_q"):
            assert (got[k] != ref[k]).float().mean() <= 1e-3, k
        elif k.endswith("x_scale"):
            _close(float(got[k]), float(ref[k]), 1e-3, 0, k)
        else:  # trained float weights and biases, and the weight scales
            _close(got[k].numpy(), ref[k].numpy(), 1e-3, 1e-3, k)
    # every parameter trained: the float head, the biases and the scales moved
    for k, v in model.state_dict().items():
        if k in got and got[k].dtype == torch.float32 and not k.endswith("w_scale"):
            assert not torch.equal(got[k], v), k
    calibrated = tq.calibrate(lambda b: model(b), *[_nchw(x) for x in xs])
    for name in ("c1", "c2", "h2"):
        assert float(getattr(q_t, name).x_scale) != np.float32(max(
            calibrated[getattr(model, name)] / 127.0, 1e-12)), name


def _first_step_taps(fq, apply_t, x, target):
    """One backward of `distill_loss` through the fake-quant model `fq`:
    {conv: (its input, its output's gradient)} for every fake-quant conv;
    the parameters' `.grad` hold the first step's gradients."""
    taps = {}

    def hook(conv, inp, out):
        xin = inp[0].detach().clone()
        out.register_hook(lambda g: taps.__setitem__(conv, (xin, g.detach().clone())))

    handles = [m.register_forward_hook(hook) for m in fq.modules()
               if isinstance(m, tl.FakeQuantConv2d)]
    try:
        tq.distill_loss(apply_t, fq, x, target).backward()
    finally:
        for h in handles:
            h.remove()
    return taps


def _rel(got, ref):
    ref = torch.as_tensor(np.asarray(ref, np.float32))
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


@functools.partial(jax.jit, static_argnums=(3, 4))
def _fq_conv_vjp(p, x, g, stride, dilation):
    """The JAX fake-quant conv's (parameter, input) gradients at output
    gradient `g`."""
    _, vjp = jax.vjp(lambda pp, xx: jq.fake_quant_conv_apply(
        pp, xx, stride=stride, dilation=dilation), p, x)
    return vjp(g)


#: worst-leaf relative norm of a fake-quant conv's gradients against the
#: reference at the same input and output gradient. Measured on the tiny
#: HRNet / YOLO in f32, port against JAX: weight, bias and input at most
#: 1.4e-6; `fq_x_scale` at most 4.7e-3, median 2.7e-5. Its LSQ gradient
#: sums terms of both signs over the whole input, so where they cancel
#: the f32 summation noise of the input's gradient is amplified.
GRAD_LIMITS = {"weight": 1e-5, "bias": 1e-5, "input": 1e-5, "fq_x_scale": 2e-2}


@pytest.mark.parametrize("net", ["hrnet", "yolo"])
def test_distill_qat_first_gradients_match_jax(net):
    """The first QAT step's gradients, leaf by leaf, from one fake-quant
    start (the JAX tree loaded into the port). Each fake-quant conv is held
    at its own input and output gradient from the port's backward, against
    `jax.vjp` of the JAX conv: its weight, bias and `fq_x_scale` gradients
    (what Adam takes) and its input gradient (what flows on), by the
    worst leaf's relative norm (`GRAD_LIMITS`). The whole-network
    gradients are not held to that: an int8 code flip in one conv input
    (f32 summation order) spreads through a random-weight net."""
    cfg, params, model, x, apply_j, apply_t, skip_j, skip_t = _net(net)
    scales = jq.calibrate(lambda b: apply_j(params, b), jnp.asarray(x))
    fq_j = jq.fake_quant_convs(params, scales, skip_j)
    fq_t = tq.fake_quant_convs(model, tq.uncalibrated_scales(model, skip_t), skip_t)
    fq_t.load_state_dict(_sd(fq_j), strict=True)
    with torch.no_grad():
        target = [t.to(torch.float32) for t in tq._as_list(apply_t(model, _nchw(x)))]
    taps = _first_step_taps(fq_t, apply_t, _nchw(x), target)
    paths = {m: n for n, m in fq_t.named_modules()}
    assert len(taps) == sum(isinstance(m, tl.FakeQuantConv2d) for m in fq_t.modules()) > 30
    worst = {}
    for conv, (xin, g) in taps.items():
        p = {k: jnp.asarray(v.detach().numpy()) for k, v in
             (("weight", conv.weight.permute(2, 3, 1, 0)), ("bias", conv.bias),
              ("fq_x_scale", conv.fq_x_scale)) if v is not None}
        gp, gx = _fq_conv_vjp(p, jnp.asarray(_nhwc(xin)), jnp.asarray(_nhwc(g)),
                              conv.stride, conv.dilation)
        xx = xin.requires_grad_(True)
        (gx_t,) = torch.autograd.grad(tq.fake_quant_conv_apply(conv, xx), xx, g)
        leaves = {"input": (gx_t, _nchw(gx)), "weight": (conv.weight.grad,
                  np.asarray(gp["weight"]).transpose(3, 2, 0, 1)),
                  "fq_x_scale": (conv.fq_x_scale.grad, gp["fq_x_scale"])}
        if conv.bias is not None:
            leaves["bias"] = (conv.bias.grad, gp["bias"])
        for leaf, (got, ref) in leaves.items():
            worst[f"{paths[conv]}.{leaf}"] = _rel(got, ref)
    for leaf, limit in GRAD_LIMITS.items():
        errs = {k: v for k, v in worst.items() if k.endswith("." + leaf)}
        assert len(errs) == len(taps) or leaf == "bias"
        assert max(errs.values()) <= limit, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("net", ["hrnet", "yolo"])
def test_distill_qat_three_steps_matches_jax(net):
    """The whole tiny networks, a sanity bound on the trajectory. A
    random-weight net amplifies one int8 code flip in one conv input (f32
    summation order: 1 flip at HRNet stage 2 became 60 by stage 3,
    measured) into losses that move by 2-18% and gradients whose signs
    differ on some entries; so the trajectory is held by Adam's own bound:
    from one start, each step moves an entry by at most about lr on either
    side, so 3 steps stay within 6.1 lr. The gradients themselves are held
    tightly by `test_distill_qat_first_gradients_match_jax`."""
    cfg, params, model, x, apply_j, apply_t, skip_j, skip_t = _net(net)
    lr, logs_j, logs_t = 1e-5, [], []
    q_j = jq.distill_qat(apply_j, params, cfg, [jnp.asarray(x)], steps=3, lr=lr,
                         skip_ids=skip_j, log=lambda i, v: logs_j.append((i, v)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    q_t = tq.distill_qat(apply_t, model, [_nchw(x)], steps=3, lr=lr, skip_ids=skip_t,
                         log=lambda i, v: logs_t.append((i, v)))
    assert [i for i, _ in logs_t] == [i for i, _ in logs_j] == [1, 2, 3]
    (_, first_t), (_, first_j) = logs_t[0], logs_j[0]
    np.testing.assert_allclose(first_t, first_j, rtol=5e-2)
    assert logs_t[-1][1] < first_t and logs_j[-1][1] < first_j
    for k, v in model.state_dict().items():  # the teacher is left as it was
        assert torch.equal(v, before[k]), k
    ref, got = _sd(q_j), q_t.state_dict()
    assert set(got) == set(ref)
    equal = total = 0
    for k in ref:
        if k.endswith("weight_q"):
            diff = (got[k].int() - ref[k].int()).abs()
            assert int(diff.max()) <= 1, k
            equal += int((diff == 0).sum())
            total += diff.numel()
        elif k.endswith("x_scale"):
            assert abs(float(got[k]) - float(ref[k])) <= 6.1 * lr + 1e-5 * float(ref[k]), k
        elif not k.endswith("w_scale"):
            assert float((got[k] - ref[k]).abs().max()) <= 6.1 * lr, k
    assert total > 0 and equal >= 0.99 * total, (equal, total)
    with torch.no_grad():
        assert all(torch.isfinite(o).all() for o in tq._as_list(q_t(_nchw(x), torch.float32)))


# -- cross-layer equalization, MSE calibration, bias correction, BN statistics ----

@pytest.mark.parametrize("folded", [True, False])
def test_equalize_convs_matches_jax(folded):
    _, params, model, x, apply_j, _, _, _ = _net("hrnet", fold=folded, bn_stats=False)
    ch_j = jq.calibrate(lambda b: apply_j(params, b), jnp.asarray(x), per_channel=True)
    eq_j = _sd(jq.equalize_convs(params, ch_j, alpha=0.5))
    eq_t = tq.equalize_convs(model, _by_name(ch_j, params, model), alpha=0.5)
    orig = _sd(params)
    sd = eq_t.state_dict()
    changed_j = {k for k in orig if not torch.equal(eq_j[k], orig[k])}
    changed_t = {k for k in orig if not torch.equal(sd[k], orig[k])}
    assert changed_t == changed_j
    if folded:
        assert {"conv1.weight", "conv2.weight", "layer1.0.conv3.weight"} <= changed_t
        assert not any(k.startswith("final_layer") for k in changed_t)
    else:
        assert not changed_t  # a live BN between the convs: no pair
    for k in orig:
        _close(sd[k].numpy(), eq_j[k].numpy(), 1e-6, 1e-7, k)
    for k, v in model.state_dict().items():  # the input model is left as it was
        assert torch.equal(v, orig[k]), k


def _grid_index(ranges, absmax, grid):
    return {k: int(np.argmin(np.abs(np.asarray(grid) - v / absmax[k]))) for k, v in ranges.items()}


@pytest.mark.parametrize("net", ["hrnet", "yolo"])
def test_calibrate_mse_matches_jax(net):
    _, params, model, x, apply_j, apply_t, _, _ = _net(net)
    run_j = lambda b: apply_j(params, b)  # noqa: E731
    run_t = lambda b: apply_t(model, b)  # noqa: E731
    grid = jq._ACT_MSE_GRID
    assert tq._ACT_MSE_GRID == grid
    idx_j = _grid_index(jq.calibrate_mse(run_j, jnp.asarray(x)),
                        jq.calibrate(run_j, jnp.asarray(x)), grid)
    idx_t = _grid_index(tq.calibrate_mse(run_t, _nchw(x)), tq.calibrate(run_t, _nchw(x)), grid)
    paths = _conv_paths(params)
    names = {m: n for n, m in model.named_modules()}
    got = {names[m]: i for m, i in idx_t.items()}
    ref = {paths[k]: i for k, i in idx_j.items()}
    assert got == ref and len(ref) > 30
    assert len(set(ref.values())) > 1  # not all at one end of the grid


def test_bias_correct_convs_matches_jax():
    cfg, params, model, x, apply_j, apply_t, skip_j, skip_t = _net("hrnet")
    run_j = lambda b: apply_j(params, b)  # noqa: E731
    scales_j = jq.calibrate(run_j, jnp.asarray(x))
    qp = jq.quantize_convs(params, scales_j, skip_j)
    means_j = jq.record_bias_correction_means(run_j, jnp.asarray(x), scales_j)
    ref = _sd(jq.bias_correct_convs(params, qp, means_j))

    scales_t = _by_name(scales_j, params, model)
    qm = tq.quantize_convs(model, scales_t, skip_t)
    qm.load_state_dict(_sd(qp), strict=True)
    means_t = tq.record_bias_correction_means(lambda b: apply_t(model, b), _nchw(x), scales_t)
    paths = _conv_paths(params)
    names = {m: n for n, m in model.named_modules()}
    assert {names[m] for m in means_t} == {paths[k] for k in means_j}
    for k, (m, mq) in means_j.items():
        got_m, got_mq = means_t[model.get_submodule(paths[k])]
        _close(got_m, m, 1e-5, 1e-5, paths[k])
        _close(got_mq, mq, 1e-5, 1e-5, paths[k])

    got = tq.bias_correct_convs(model, qm, _by_name(means_j, params, model)).state_dict()
    assert set(got) == set(ref)
    moved = 0
    for k in ref:
        if k.endswith("bias"):
            _close(got[k].numpy(), ref[k].numpy(), 1e-5, 1e-6, k)
            moved += not torch.equal(got[k], qm.state_dict()[k])
        else:
            assert torch.equal(got[k], ref[k]), k
    assert moved == sum(isinstance(m, tl.QuantConv2d) for m in qm.modules())
    assert torch.equal(got["final_layer.bias"], qm.final_layer.bias)


@pytest.mark.parametrize("net", ["hrnet", "yolo"])
def test_calibrate_bn_stats_matches_jax(net):
    _, raw, model, x, apply_j, apply_t, _, _ = _net(net, fold=False, bn_stats=False)
    jq.calibrate_bn_stats(lambda b: apply_j(raw, b), jnp.asarray(x))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tq.calibrate_bn_stats(lambda b: apply_t(model, b), _nchw(x))
    ref, got = _sd(raw), model.state_dict()
    n = 0
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            # YOLO's BNs sit up to 75 layers deep: its means near 0 get a
            # larger floor for the f32 noise summed on the way
            _close(got[k].numpy(), ref[k].numpy(), 1e-5, 1e-5 if net == "hrnet" else 5e-5, k)
            assert not torch.equal(got[k], before[k]), k
            n += 1
        else:
            assert torch.equal(got[k], before[k]), k
    assert n == 2 * sum(isinstance(m, tl.BatchNorm2d) for m in model.modules())
    # the recorder is off again: a forward uses the new running statistics
    assert tl.BNStatRecorder.active is None
