"""The trainer `tpupose_torch.models.train` and `convert.adam_state_from_jax`
against `tpupose.models.train` and optax, on the tiny HRNet in f32.

Inputs are made with numpy from a seed and given to both packages (the
JAX package's NHWC arrays transposed to NCHW); weights and optimizer
states cross over through `models/convert.py`. The JAX side runs once per
case in module-scope fixtures, jitted.

Tolerances and why:
* `blob_localization_batch`: exactly equal (the same numpy draws and
  arithmetic); `gaussian_target_heatmaps` within 1e-6 (the two `exp`s
  differ in the last bit).
* `heatmap_loss`: rtol 1e-5 (f32 convolutions summed in another order).
* First-step gradients of every trained tensor, BN running statistics
  included, on the blob batch, worst-leaf relative norm:
  - against the JAX package's loss differentiated in f64 (`jax.enable_x64`,
    its recorder's statistics in f64 too; JAX_F64_LIMITS), the tight check
    across the packages: measured 1.0e-6 with inference-mode BN and 1.8e-5
    with train-mode BN;
  - against jax.grad in f32 (GRAD_LIMITS): measured 2.1e-6 and 1.3e-2. The
    train-mode reading is JAX's own error, which the f64 test reproduces:
    JAX's f32 gradients lie 2.0e-6 and 1.3e-2 from that f64 evaluation (a
    channel whose mean dwarfs its spread cancels in the train-mode
    backward, and XLA's CPU reductions round more than torch's: a
    768-sample f32 mean, 7.0e-7 against 1.3e-7 relative);
  - under `train_bn`, also each of the port's 40 BNs, at its own input and
    one output cotangent, against jax.vjp of the JAX `bn_apply` (output,
    input, weight and bias gradients within BN_LIMIT, measured 1.2e-5), and
    the whole network against its own f64 evaluation (F64_LIMIT, measured
    1.8e-5).
* 3 optimizer steps from one start on the blob batch, `make_optimizer()`
  (AdamW) against `optax.adamw` and `torch.optim.Adam` against
  `optax.adam`: losses within LOSS_RTOL, rtol 1e-4 with inference-mode
  BN and 1e-3 with train-mode BN, where JAX's gradient error above moves
  its trajectory (measured 3.1e-4 at the third step). The BN running statistics move as
  JAX's do: under `train_bn` (zero gradients) by the decay alone, within
  rtol 1e-6; without it by their gradients, in JAX's direction on at least
  99% of the entries (Adam moves an entry by about lr whatever the size of
  its gradient, so a sign is what a near-zero gradient leaves to compare).
* `adam_state_from_jax` after 2 AdamW steps: `exp_avg` / `exp_avg_sq`
  equal to optax's `mu` / `nu` (a transpose and nothing else), `step`
  equal to `count`, and the next step's loss within rtol 1e-4 of JAX's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import tpupose.models.hrnet as jh
import tpupose.models.train as jt
import tpupose_torch.models.hrnet as th
import tpupose_torch.models.layers as tl
import tpupose_torch.models.quantize as tq
import tpupose_torch.models.train as tt
from tpupose_torch.models.convert import adam_state_from_jax, state_dict_from_jax

torch.set_num_threads(1)

#: worst-leaf relative norm of the first step's gradients against jax.grad,
#: by `train_bn` (measured 2.1e-6 and 1.3e-2; see the module docstring)
GRAD_LIMITS = {False: 5e-6, True: 3e-2}
#: the same against the JAX loss differentiated in f64, by `train_bn`
#: (measured 1.0e-6 and 1.8e-5)
JAX_F64_LIMITS = {False: 5e-6, True: 5e-5}
#: each train-mode BN against jax.vjp at its own input (measured 1.2e-5)
BN_LIMIT = 3e-5
#: the port's train-mode gradients against its own f64 evaluation
#: (measured 1.8e-5)
F64_LIMIT = 5e-5
STEPS = 3
#: losses of 3 steps against optax, by `train_bn` (see the module docstring)
LOSS_RTOL = {False: 1e-4, True: 1e-3}
BATCH = 2


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _sd(tree):
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


def _jax_tree(sd):
    """A port state_dict as the JAX package's parameter tree (the inverse
    of `state_dict_from_jax`): nested dicts by dotted name, 4-D kernels
    HWIO, no `num_batches_tracked`."""
    tree = {}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        arr = t.detach().numpy()
        node[leaf] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
    return tree


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    den = torch.linalg.vector_norm(ref)
    if den == 0:
        return float(torch.linalg.vector_norm(got))
    return float(torch.linalg.vector_norm(got - ref) / den)


@pytest.fixture(scope="module")
def setup():
    """The tiny config, He-normal weights (torch seed 3) as a JAX tree, and
    the blob batch (seed 0) with its targets, as numpy."""
    cfg = jh.tiny_test_config()
    params = _jax_tree(th.hrnet_init(th.tiny_test_config(), torch.Generator().manual_seed(3))
                       .state_dict())
    imgs, kps = jt.blob_localization_batch(np.random.default_rng(0), cfg, BATCH)
    targets, weights = jt.gaussian_target_heatmaps(cfg, kps)
    return {"cfg": cfg, "params": params, "imgs": np.asarray(imgs), "kps": np.asarray(kps),
            "targets": np.asarray(targets), "weights": np.asarray(weights)}


def _port(setup, params=None):
    model = th.HRNet(th.tiny_test_config())
    model.load_state_dict(_sd(setup["params"] if params is None else params), strict=True)
    return model


def _batch(setup):
    return (_nchw(setup["imgs"]), _nchw(setup["targets"]).float(),
            torch.from_numpy(setup["weights"]))


def _named_trained(model):
    """name -> tensor for every tensor `trained_tensors` returns."""
    ids = {id(t) for t in tt.trained_tensors(model)}
    named = dict(model.named_parameters())
    named.update((n, b) for n, b in model.named_buffers() if id(b) in ids)
    assert len(named) == len(ids)
    return named


# -- data -----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11])
def test_blob_batch_equals_jax(seed):
    cfg = th.tiny_test_config()
    imgs_j, kps_j = jt.blob_localization_batch(np.random.default_rng(seed), jh.tiny_test_config(), 3)
    imgs_t, kps_t = tt.blob_localization_batch(np.random.default_rng(seed), cfg, 3, device="cpu")
    assert imgs_t.shape == (3, 3, *cfg.input_size) and imgs_t.dtype == torch.float32
    np.testing.assert_array_equal(imgs_t.numpy(), np.asarray(imgs_j).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(kps_t.numpy(), np.asarray(kps_j))
    np.testing.assert_array_equal(tt.JOINT_COLORS, jt.JOINT_COLORS)


def test_gaussian_targets_match_jax(setup):
    cfg = th.tiny_test_config()
    heat, weights = tt.gaussian_target_heatmaps(cfg, torch.from_numpy(setup["kps"]))
    assert heat.shape == (BATCH, 17, *cfg.heatmap_size)
    np.testing.assert_allclose(heat.numpy(), setup["targets"].transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(weights.numpy(), setup["weights"])


def test_blob_batch_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.blob_localization_batch(np.random.default_rng(0), th.tiny_test_config(), 1)


# -- the JAX runs ------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": (lambda: jt.make_optimizer(), lambda ps: tt.make_optimizer(ps)),
    "adam": (lambda: optax.adam(1e-3), lambda ps: torch.optim.Adam(ps, lr=1e-3)),
}


@pytest.fixture(scope="module")
def jax_runs(setup):
    """(name, train_bn) -> (losses of STEPS jitted steps of the JAX
    `make_train_step` with that optax optimizer on the blob batch, the
    params after each step, the optimizer state after each)."""
    cfg = setup["cfg"]
    batch = (jnp.asarray(setup["imgs"]), jnp.asarray(setup["targets"]),
             jnp.asarray(setup["weights"]))
    runs = {}
    for name, (make_j, _) in OPTIMIZERS.items():
        for train_bn in (False, True):
            opt = make_j()
            step = jax.jit(jt.make_train_step(cfg, opt, jnp.float32, train_bn))
            params = jax.tree.map(jnp.asarray, setup["params"])
            state = opt.init(params)
            losses, trees, states = [], [], []
            for _ in range(STEPS):
                params, state, loss = step(params, state, *batch)
                losses.append(float(loss))
                trees.append(jax.tree.map(np.asarray, params))
                states.append(jax.tree.map(np.asarray, state))
            runs[name, train_bn] = (losses, trees, states)
    return runs


# -- loss and first-step gradients -------------------------------------------------------

@pytest.mark.parametrize("train_bn", [False, True])
def test_heatmap_loss_matches_jax(setup, jax_runs, train_bn):
    """`heatmap_loss` at the start weights against the JAX step's first
    loss (its `heatmap_loss` there)."""
    with torch.no_grad():
        got = float(tt.heatmap_loss(_port(setup), *_batch(setup), torch.float32, train_bn))
    np.testing.assert_allclose(got, jax_runs["adam", train_bn][0][0], rtol=1e-5)
    assert tl.BNStatRecorder.active is None


@pytest.mark.parametrize("train_bn", [False, True])
def test_first_step_gradients_match_jax(setup, jax_runs, train_bn):
    """The whole network's first-step gradients on the blob batch against
    jax.grad's in the JAX step, leaf by leaf, the running statistics
    included (zero under `train_bn`, as JAX gives them). JAX's are read off
    optax.adam's first moment after one step, mu = (1 - b1) g, to within
    an ulp."""
    ref = {k: v / np.float32(0.1) for k, v in _sd(jax_runs["adam", train_bn][2][0][0].mu).items()}
    model = _port(setup)
    named = _named_trained(model)
    opt = tt.make_optimizer(list(named.values()))
    tt.make_train_step(model, opt, torch.float32, train_bn)(*_batch(setup))
    assert set(named) == {k for k in ref if not k.endswith("num_batches_tracked")}
    stats = [n for n in named if n.endswith(("running_mean", "running_var"))]
    assert stats and all(named[n].grad is not None for n in stats)
    if train_bn:
        assert all(not named[n].grad.any() and not ref[n].any() for n in stats)
    else:
        assert all(named[n].grad.any() for n in stats)
    worst = max((_rel(t.grad, ref[n]), n) for n, t in named.items())
    assert worst[0] <= GRAD_LIMITS[train_bn], worst


def test_train_mode_bn_backward_matches_jax(setup):
    """Each BN of the network in train mode, at the input it sees in the
    port's forward on the blob batch and one random output cotangent:
    output and the gradients of input, weight and bias against jax.vjp of
    the JAX `bn_apply` under its `BNStatRecorder`, within BN_LIMIT by relative
    norm."""
    import tpupose.models.layers as jl

    model = _port(setup)
    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda m, a: inputs.setdefault(m, a[0].detach()))
             for m in model.modules() if isinstance(m, tl.BatchNorm2d)]
    with torch.no_grad():
        tt.heatmap_loss(model, *_batch(setup), torch.float32, train_bn=True)
    for h in hooks:
        h.remove()
    def train_bn(xj, wj, bj):
        jl.BNStatRecorder.active = jl.BNStatRecorder()
        try:
            return jl.bn_apply({"weight": wj, "bias": bj, "running_mean": 0 * bj,
                                "running_var": 0 * bj + 1}, xj)
        finally:
            jl.BNStatRecorder.active = None

    @jax.jit
    def forward_backward(xj, wj, bj, cj):
        y, vjp = jax.vjp(train_bn, xj, wj, bj)
        return (y, *vjp(cj))

    rng = np.random.default_rng(2)
    worst = 0.0
    for bn, x in inputs.items():
        c = rng.standard_normal(tuple(x.shape)).astype(np.float32)
        w, b = bn.weight.detach().numpy(), bn.bias.detach().numpy()
        y_j, gx_j, gw_j, gb_j = forward_backward(
            np.ascontiguousarray(x.numpy().transpose(0, 2, 3, 1)), w, b,
            np.ascontiguousarray(c.transpose(0, 2, 3, 1)))
        xt = x.clone().requires_grad_(True)
        tl.BNStatRecorder.active = tl.BNStatRecorder()
        try:
            y = tl.bn_apply(bn, xt)
        finally:
            tl.BNStatRecorder.active = None
        gx, gw, gb = torch.autograd.grad(y, [xt, bn.weight, bn.bias], torch.from_numpy(c))
        for got, want in ((y.detach(), y_j), (gx, gx_j), (gw, gw_j), (gb, gb_j)):
            want = np.asarray(want)
            want = want.transpose(0, 3, 1, 2) if want.ndim == 4 else want
            worst = max(worst, _rel(got, torch.from_numpy(np.ascontiguousarray(want))))
    assert len(inputs) == 40 and worst <= BN_LIMIT, (len(inputs), worst)


@pytest.mark.parametrize("train_bn", [False, True])
def test_first_step_gradients_close_to_jax_f64(setup, jax_runs, monkeypatch, train_bn):
    """The port's f32 first-step gradients on the blob batch against the JAX
    package's `heatmap_loss` differentiated in f64 (under
    `jax.enable_x64`, its recorder's statistics taken in f64
    too): worst leaf within JAX_F64_LIMITS, the tight check across the
    two packages. JAX's own f32 gradients (the reference of the test above) lie
    within GRAD_LIMITS of the same f64 evaluation, the reading that sets
    those limits."""
    import tpupose.models.layers as jl

    def observe(self, p, x):
        axes = tuple(range(x.ndim - 1))
        m, v = jnp.mean(x, axes), jnp.var(x, axes)
        self.taps.append((p, m, v))
        return m, v

    monkeypatch.setattr(jl.BNStatRecorder, "observe", observe)
    cfg = setup["cfg"]
    with jax.enable_x64(True):
        grad = jax.jit(jax.grad(lambda p, *b: jt.heatmap_loss(p, cfg, *b, jnp.float64, train_bn)))
        tree = grad(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), setup["params"]),
                    *(jnp.asarray(setup[k], jnp.float64) for k in ("imgs", "targets", "weights")))
        ref = _sd(tree)
    assert all(t.dtype == torch.float64 for k, t in ref.items() if k.endswith("weight"))
    model = _port(setup)
    named = _named_trained(model)
    tt.make_train_step(model, tt.make_optimizer(list(named.values())), torch.float32,
                       train_bn)(*_batch(setup))
    port = max((_rel(t.grad, ref[n]), n) for n, t in named.items())
    assert port[0] <= JAX_F64_LIMITS[train_bn], port
    jax_f32 = {k: v / np.float32(0.1) for k, v in _sd(jax_runs["adam", train_bn][2][0][0].mu).items()}
    jax_worst = max((_rel(jax_f32[n], ref[n]), n) for n in named)
    assert jax_worst[0] <= GRAD_LIMITS[train_bn], jax_worst


def test_train_bn_gradients_close_to_f64(setup, monkeypatch):
    """The port's train-mode first-step gradients on the blob batch in f32
    against the same computation in f64 (the recorder's statistics in f64
    too): worst leaf within F64_LIMIT."""
    def observe(self, bn, x):
        m = x.mean(dim=(0, 2, 3))
        v = torch.square(x - m[:, None, None]).mean(dim=(0, 2, 3))
        self.taps.append((bn, m, v))
        return m, v

    grads = {}
    for dtype in (torch.float32, torch.float64):
        if dtype == torch.float64:
            monkeypatch.setattr(tl.BNStatRecorder, "observe", observe)
        model = _port(setup).to(dtype)
        named = _named_trained(model)
        tt.heatmap_loss(model, *(t.to(dtype) for t in _batch(setup)), dtype, True).backward()
        grads[dtype] = {n: t.grad for n, t in named.items() if t.grad is not None}
    assert len(grads[torch.float32]) == len(grads[torch.float64]) > 100
    worst = max((_rel(g, grads[torch.float64][n]), n) for n, g in grads[torch.float32].items())
    assert worst[0] <= F64_LIMIT, worst


# -- optimizer steps against optax ---------------------------------------------------------

@pytest.mark.parametrize("train_bn", [False, True])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_steps_match_optax(setup, jax_runs, name, train_bn):
    losses_j, trees, _ = jax_runs[name, train_bn]
    model = _port(setup)
    named = _named_trained(model)
    start = {n: t.detach().clone() for n, t in named.items()}
    step = tt.make_train_step(model, OPTIMIZERS[name][1](list(named.values())), torch.float32,
                              train_bn)
    losses = [float(step(*_batch(setup))) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, losses_j, rtol=LOSS_RTOL[train_bn])
    assert losses[-1] < losses[0]
    ref = _sd(trees[-1])
    for n in (n for n in named if n.endswith(("running_mean", "running_var"))):
        got, want = named[n].detach(), ref[n]
        if train_bn:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, err_msg=n)
            if name == "adam":
                assert torch.equal(got, start[n]), n
        else:
            moved_j, moved_t = want - start[n], got - start[n]
            agree = float((torch.sign(moved_j) == torch.sign(moved_t)).float().mean())
            assert agree >= 0.99, (n, agree)
    if train_bn and name == "adamw":
        assert any(not torch.equal(named[n], start[n]) for n in named if n.endswith("running_var"))


def test_adam_state_from_jax_resumes_a_jax_run(setup, jax_runs):
    losses_j, trees, states = jax_runs["adamw", False]
    model = _port(setup, trees[1])
    named = _named_trained(model)
    opt = tt.make_optimizer(list(named.values()))
    opt.load_state_dict(adam_state_from_jax(states[1], model, opt))
    adam = states[1][0]
    mu, nu = _sd(adam.mu), _sd(adam.nu)
    for i, n in enumerate(named):
        st = opt.state[named[n]]
        assert torch.equal(st["exp_avg"], mu[n]) and torch.equal(st["exp_avg_sq"], nu[n]), n
        assert float(st["step"]) == float(adam.count) == 2.0
    loss = float(tt.make_train_step(model, opt, torch.float32)(*_batch(setup)))
    np.testing.assert_allclose(loss, losses_j[2], rtol=1e-4)


def test_adam_state_from_jax_refuses_a_foreign_tensor(setup, jax_runs):
    _, _, states = jax_runs["adam", False]
    model = _port(setup)
    stray = torch.zeros(3, requires_grad=True)
    opt = torch.optim.Adam(tt.trained_tensors(model) + [stray])
    with pytest.raises(ValueError, match="no JAX state"):
        adam_state_from_jax(states[0], model, opt)


# -- a fake-quant model ------------------------------------------------------------------

def test_fake_quant_steps_lower_loss_and_move_scale():
    """As tests/test_quantize.py's QAT steps: Adam 1e-3 on a fake-quant copy
    of the BN-calibrated, folded tiny HRNet lowers the loss and trains the
    activation scales; the result requantizes to a finite int8 model."""
    cfg = th.tiny_test_config()
    imgs, kps = tt.blob_localization_batch(np.random.default_rng(5), cfg, 2, device="cpu")
    targets, weights = tt.gaussian_target_heatmaps(cfg, kps)
    raw = th.hrnet_init(cfg, torch.Generator().manual_seed(9))
    tq.calibrate_bn_stats(lambda b: raw(b, torch.float32), imgs)
    folded = tl.fold_batchnorm(raw)
    scales = tq.calibrate(lambda b: folded(b), imgs)
    fq = tq.fake_quant_convs(folded, scales, tq.hrnet_skip_ids(folded))
    s_before = float(fq.layer1[0].conv1.fq_x_scale)
    opt = torch.optim.Adam(tt.trained_tensors(fq), lr=1e-3)
    step = tt.make_train_step(fq, opt, torch.float32)
    with torch.no_grad():
        loss0 = float(tt.heatmap_loss(fq, imgs, targets, weights, torch.float32))
    for _ in range(8):
        loss = float(step(imgs, targets, weights))
    assert loss < loss0, (loss, loss0)
    assert float(fq.layer1[0].conv1.fq_x_scale) != s_before
    with torch.no_grad():
        out = tq.requantize_after_qat(fq)(imgs)
    assert torch.isfinite(out).all()
