"""The training steps as captured programs (`runtime.graphs.CapturedUpdate`:
`models.train.make_train_step`, `quantize.distill_qat`) on the CPU, where
the same calls run the body eagerly at each warm-up and replay.

(a) The captured step equals the eager body (`graphs.disable_capture()`)
    bit for bit over 6 steps, f32 and bf16, both BN modes: losses,
    trained tensors, optimizer state and `.grad`; 2 warm-ups, then a
    capture that replays once (the step count says so), then replays.
(b) A new batch shape after step 3 is a new key, and the old shape
    replays its graph again: still equal to eager, the step count right,
    every `.grad` the same tensor throughout.
(c) Capturability: after the warm-ups every step issues the same aten ops
    with the same non-tensor arguments, shapes and dtypes, and reads
    nothing on the host (recorded under a `TorchDispatchMode` on fresh
    batches), for the train step in f32 / bf16 and both BN modes (the
    `BNStatRecorder`'s ops included) and for distill-QAT's step on both
    tiny networks.
(d) A changed backend flag is a new key; a changed optimizer setting after
    the capture drops the graphs, so the next steps warm up and capture
    anew, and the run equals eager with the same change.
(e) `distill_qat` with a short last batch (a second key) equals its eager
    loop, module for module.
(f) Save, restore into fresh objects (or into the same ones after their
    capture) and continue equals an uninterrupted run.
(g) A non-capturable optimizer is refused for CUDA (`require_capturable`,
    as a CUDA step calls it; the refusal itself needs a card to reach);
    `make_optimizer` and `distill_qat` build capturable optimizers only on
    the card, and `restore_params` keeps the optimizer's own setting.

(h) The card's step against `jax.jit` of the JAX package's train step with
    `optax.adamw`: 6 steps (the 3rd the capture, then replays) of the
    captured step with capturable foreach AdamW, as the card runs it, on
    the same weights and batch, losses within tests/test_torch_train.py's
    rtol (1e-4). That file (3 optax steps, the CPU's Adam)
    and tests/test_torch_qat.py (3 and 6 steps) hold the rest of the JAX
    parity through the same CapturedUpdate.
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import tpupose.models.hrnet as jh
import tpupose.models.train as jt
from tpupose_torch.models import quantize as tq
from tpupose_torch.models import train as tt
from tpupose_torch.models.checkpoint import restore_params, save_params
from tpupose_torch.models.hrnet import hrnet_init, tiny_test_config
from tpupose_torch.models.layers import fold_batchnorm
from tpupose_torch.models.yolov3 import tiny_yolo_test_config, yolov3_init
from tpupose_torch.runtime import graphs

torch.set_num_threads(1)
STEPS = 6
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CFG = tiny_test_config()
FLAGS = {
    "cudnn.allow_tf32": (torch.backends.cudnn, "allow_tf32"),
    "cudnn.deterministic": (torch.backends.cudnn, "deterministic"),
    "cudnn.benchmark": (torch.backends.cudnn, "benchmark"),
    "cuda.matmul.allow_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
}


def _batch(seed, n=2):
    imgs, kps = tt.blob_localization_batch(np.random.default_rng(seed), CFG, n, device="cpu")
    targets, weights = tt.gaussian_target_heatmaps(CFG, kps)
    return imgs, targets, weights


def _model(seed=3):
    return hrnet_init(CFG, torch.Generator().manual_seed(seed))


def _one(dtype=torch.float32, train_bn=False):
    """A model, its `make_optimizer()` and its step."""
    model = _model()
    opt = tt.make_optimizer(tt.trained_tensors(model))
    return model, opt, tt.make_train_step(model, opt, dtype, train_bn)


def _pair(dtype=torch.float32, train_bn=False):
    """Two of `_one`, from the same weights."""
    return [_one(dtype, train_bn) for _ in range(2)]


def _run(step, batches, eager=False):
    if eager:
        with graphs.disable_capture():
            return [step(*b) for b in batches]
    return [step(*b) for b in batches]


def _everything(model, opt):
    """Trained tensors, their gradients and the optimizer state, by name."""
    out = {}
    for name, t in tt.named_trained_tensors(model):
        out[name] = t.detach()
        out[name + ".grad"] = t.grad
        for k, v in opt.state[t].items():
            out[f"{name}.{k}"] = v
    return out


def _assert_same(a, b):
    (ma, oa, *_), (mb, ob, *_) = a, b
    ea, eb = _everything(ma, oa), _everything(mb, ob)
    assert ea.keys() == eb.keys() and len(ea) > 800
    for k, v in ea.items():
        assert v is not None and torch.equal(v, eb[k]), k


def _assert_losses(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and torch.equal(g, r), (i, float(g), float(r))


def _steps_taken(opt):
    return {float(st["step"]) for st in opt.state.values()}


# -- (a), (b) ----------------------------------------------------------------------

@pytest.mark.parametrize("train_bn", [False, True], ids=["bn_inference", "bn_train"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_captured_step_equals_eager(dtype, train_bn):
    graphed, eager = _pair(DTYPES[dtype], train_bn)
    batches = [_batch(0)] * STEPS
    losses = _run(graphed[2], batches)
    _assert_losses(losses, _run(eager[2], batches, eager=True))
    _assert_same(graphed, eager)
    assert _steps_taken(graphed[1]) == {float(STEPS)}
    (key,) = graphed[2].stats()
    assert (key["warmups"], key["replays"]) == (graphs.WARMUP, STEPS - graphs.WARMUP)
    assert key["capture_s"] is not None and key["graph_nodes"] is None
    if train_bn:  # the statistics take no part: zero gradients, still decayed
        stats = [t for n, t in tt.named_trained_tensors(graphed[0]) if n.endswith("running_var")]
        assert all(not t.grad.any() for t in stats)


@pytest.mark.parametrize("train_bn", [False, True], ids=["bn_inference", "bn_train"])
def test_new_batch_shape_is_a_new_key(train_bn):
    graphed, eager = _pair(torch.float32, train_bn)
    a, b = _batch(1, 2), _batch(2, 3)
    batches = [a, a, a, b, b, a, a, b]
    held = list(graphed[2]._grads)  # (tensor, its gradient), made before the first step
    losses = _run(graphed[2], batches)
    _assert_losses(losses, _run(eager[2], batches, eager=True))
    _assert_same(graphed, eager)
    assert _steps_taken(graphed[1]) == {float(len(batches))}
    assert len(held) > 200 and all(p.grad is g for p, g in held)
    assert [(k["shapes"][0][0], k["warmups"], k["replays"]) for k in graphed[2].stats()] == [
        (2, 2, 3), (3, 2, 1)]


# -- (c) -----------------------------------------------------------------------------

class _OpRecorder(TorchDispatchMode):
    """Every op reaching the dispatcher, with its non-tensor arguments and
    its tensors' shapes, dtypes and devices; `cut()` starts a new step."""

    def __init__(self):
        super().__init__()
        self.steps = [[]]

    def cut(self):
        self.steps.append([])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not str(func).startswith("profiler."):  # record_function marks: no work
            leaves, spec = tree_flatten((args, kwargs))
            self.steps[-1].append((str(func), str(spec), tuple(
                (tuple(x.shape), x.dtype, x.device.type) if isinstance(x, torch.Tensor)
                else repr(x) for x in leaves)))
        return func(*args, **kwargs)


def _assert_one_sequence(steps):
    """Every step the same ops, and none reads a value on the host."""
    first = steps[0]
    assert len(first) > 500
    assert not [op for op, *_ in first if "_local_scalar_dense" in op or "aten.item" in op]
    for i, ops in enumerate(steps[1:]):
        assert ops == first, f"step {i + 1} after the warm-ups issued other ops"


@pytest.fixture
def card_adam(monkeypatch):
    """Adam and AdamW as the card runs them, here on the CPU: capturable
    (the step count and the bias corrections stay on the device; the
    CPU's own Adam reads the step count on the host and bakes its bias
    corrections into each step's ops) and foreach (CUDA's default)."""
    from torch.optim import adam

    monkeypatch.setattr(adam, "_get_capturable_supported_devices", lambda *_, **__: ["cpu"])
    monkeypatch.setattr(adam, "_default_to_fused_or_foreach", lambda *_, **__: (False, True))
    monkeypatch.setattr(tq, "capturable", lambda tensors: True)


@pytest.mark.parametrize("train_bn", [False, True], ids=["bn_inference", "bn_train"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_train_step_issues_the_same_ops_every_step(card_adam, dtype, train_bn):
    model = _model()
    opt = torch.optim.AdamW(tt.trained_tensors(model), lr=1e-3, weight_decay=1e-4,
                            capturable=True)
    step = tt.make_train_step(model, opt, DTYPES[dtype], train_bn)
    for seed in range(graphs.WARMUP):
        step(*_batch(seed))
    batches = [_batch(10 + seed) for seed in range(4)]
    rec = _OpRecorder()
    with rec:
        for i, b in enumerate(batches):
            step(*b)
            if i + 1 < len(batches):
                rec.cut()
    _assert_one_sequence(rec.steps)


def _tiny_nets():
    gen = torch.Generator().manual_seed(11)
    hr_cfg, yo_cfg = tiny_test_config(), tiny_yolo_test_config()
    return {
        "hrnet": (hrnet_init(hr_cfg, gen), torch.rand((4, 3, *hr_cfg.input_size), generator=gen),
                  tq.hrnet_skip_ids),
        "yolo": (yolov3_init(yo_cfg, gen),
                 torch.rand((4, 3, yo_cfg.input_size, yo_cfg.input_size), generator=gen),
                 lambda m: tq.yolo_skip_ids(m, yo_cfg)),
    }


def _folded(net):
    raw, x, skip_fn = _tiny_nets()[net]
    tq.calibrate_bn_stats(lambda b: raw(b, torch.float32), x)
    return fold_batchnorm(raw), x, skip_fn


def _apply(m, b):
    return m(b, torch.float32)


@pytest.mark.parametrize("net", ["hrnet", "yolo"])
def test_qat_step_issues_the_same_ops_every_step(card_adam, net):
    folded, x, skip_fn = _folded(net)
    rec = _OpRecorder()
    steps = graphs.WARMUP + 4
    with rec:
        tq.distill_qat(_apply, folded, [x[:2]], steps=steps, skip_ids=skip_fn(folded),
                       log=lambda i, v: rec.cut())
    # each step ends with the log's read of its loss; the last cut starts
    # requantize_after_qat's ops
    after = [ops[:-1] for ops in rec.steps[graphs.WARMUP:steps]]
    assert all("_local_scalar_dense" in ops[-1][0] for ops in rec.steps[:steps])
    _assert_one_sequence(after)


# -- (d) -----------------------------------------------------------------------------

@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_backend_flag_is_part_of_the_key(flag):
    module, name = FLAGS[flag]
    step = _one()[2]
    batch = _batch(4)
    before = getattr(module, name)
    _run(step, [batch] * 3)
    setattr(module, name, not before)
    try:
        _run(step, [batch] * 3)
    finally:
        setattr(module, name, before)
    _run(step, [batch])
    keys = step.stats()
    assert [(k["flags"][flag], k["warmups"], k["replays"]) for k in keys] == [
        (before, 2, 2), (not before, 2, 1)]
    assert all(k["flags"][f] == getattr(*FLAGS[f]) for k in keys for f in FLAGS if f != flag)


@pytest.mark.parametrize("setting", ["lr", "betas", "eps", "weight_decay"])
def test_changed_optimizer_setting_captures_anew(setting):
    graphed, eager = _pair()
    batch = _batch(5)
    losses = []
    for (_, opt, step), run_eager in ((graphed, False), (eager, True)):
        out = _run(step, [batch] * 3, eager=run_eager)
        group = opt.param_groups[0]
        group[setting] = ((0.8, 0.99) if setting == "betas" else group[setting] * 0.5)
        out += _run(step, [batch] * 4, eager=run_eager)
        losses.append(out)
    _assert_losses(*losses)
    _assert_same(graphed, eager)
    (key,) = graphed[2].stats()  # the first capture was dropped with the change
    assert (key["warmups"], key["replays"]) == (2, 2)


def test_release_drops_the_graphs():
    _, opt, step = _one()
    batch = _batch(6)
    _run(step, [batch] * 3)
    step.release()
    assert step.stats() == []
    _run(step, [batch] * 3)
    assert [(k["warmups"], k["replays"]) for k in step.stats()] == [(2, 1)]
    assert _steps_taken(opt) == {6.0}


# -- (e) -----------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["hrnet", "yolo"])
def test_distill_qat_with_a_short_last_batch_equals_eager(net):
    folded, x, skip_fn = _folded(net)
    batches = [x[:3], x[3:]]  # the second is a second key
    runs = []
    for eager in (False, True):
        losses = []
        with graphs.disable_capture() if eager else contextlib.nullcontext():
            q = tq.distill_qat(_apply, copy.deepcopy(folded), batches, steps=7,
                               skip_ids=skip_fn(folded), log=lambda i, v: losses.append(v))
        runs.append((q.state_dict(), losses))
    (got, got_losses), (ref, ref_losses) = runs
    assert got_losses == ref_losses and len(got_losses) == 7
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


# -- (f) -----------------------------------------------------------------------------

@pytest.mark.parametrize("into", ["fresh", "same"])
def test_resume_equals_an_uninterrupted_run(tmp_path, into):
    whole, part = _pair(torch.float32, True)
    batches = [_batch(20 + i) for i in range(8)]
    ref = _run(whole[2], batches)
    losses = _run(part[2], batches[:4])
    save_params(str(tmp_path / "model.pt"), part[0].state_dict())
    save_params(str(tmp_path / "opt.pt"), part[1].state_dict())
    if into == "fresh":
        model = _model(9)
        restore_params(str(tmp_path / "model.pt"), like=model)
        opt = tt.make_optimizer(tt.trained_tensors(model))
        restore_params(str(tmp_path / "opt.pt"), like=opt)
        part = (model, opt, tt.make_train_step(model, opt, torch.float32, True))
    else:  # into the captured step's own objects: the new state drops its graph
        restore_params(str(tmp_path / "model.pt"), like=part[0])
        restore_params(str(tmp_path / "opt.pt"), like=part[1])
    losses += _run(part[2], batches[4:])
    _assert_losses(losses, ref)
    _assert_same(part, whole)
    assert [(k["warmups"], k["replays"]) for k in part[2].stats()] == [(2, 2)]


# -- (g) -----------------------------------------------------------------------------

def test_uncapturable_optimizer_is_refused_for_cuda():
    params = tt.trained_tensors(_model())
    with pytest.raises(ValueError, match="capturable=True"):
        graphs.require_capturable(torch.optim.Adam(params))
    with pytest.raises(ValueError, match="group 1 is not capturable"):
        graphs.require_capturable(torch.optim.AdamW(
            [{"params": params[:3], "capturable": True}, {"params": params[3:]}]))
    graphs.require_capturable(torch.optim.Adam(params, capturable=True))
    graphs.require_capturable(torch.optim.SGD(params, lr=0.1))  # no step count to capture


def test_optimizers_are_capturable_on_the_card_only(monkeypatch):
    params = tt.trained_tensors(_model())
    assert not graphs.capturable(params)
    assert tt.make_optimizer(params).param_groups[0]["capturable"] is False
    built, adam = [], torch.optim.Adam
    monkeypatch.setattr(torch.optim, "Adam", lambda ps, **kw: built.append(kw) or adam(ps, **kw))
    folded, x, skip_fn = _folded("hrnet")
    tq.distill_qat(_apply, folded, [x[:2]], steps=1, skip_ids=skip_fn(folded))
    assert built == [{"lr": 1e-5, "capturable": False}]


@pytest.mark.parametrize("saved", [False, True], ids=["from_cpu_run", "from_card_run"])
def test_restore_keeps_the_optimizers_capturable_setting(tmp_path, saved):
    model = _model()
    src = torch.optim.Adam(tt.trained_tensors(model), capturable=saved)
    path = str(tmp_path / "opt.pt")
    state = src.state_dict()
    for i, p in enumerate(tt.trained_tensors(model)):
        state["state"][i] = {"step": torch.tensor(3.0), "exp_avg": torch.zeros_like(p),
                             "exp_avg_sq": torch.ones_like(p)}
    save_params(path, state)
    dst = torch.optim.Adam(tt.trained_tensors(_model()), capturable=not saved)
    restore_params(path, like=dst)
    assert dst.param_groups[0]["capturable"] is (not saved)
    st = next(iter(dst.state.values()))
    assert float(st["step"]) == 3.0 and torch.equal(st["exp_avg_sq"], torch.ones_like(
        st["exp_avg_sq"]))


# -- (h) -----------------------------------------------------------------------------

JAX_STEPS, JAX_LOSS_RTOL = 6, 1e-4


def _jax_tree(model):
    """The port's state_dict as the JAX package's parameter tree: nested
    dicts by dotted name, 4-D kernels HWIO, no `num_batches_tracked`."""
    tree = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        arr = t.detach().numpy()
        node[leaf] = jnp.asarray(arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr)
    return tree


def test_card_step_matches_jax_jit(card_adam):
    imgs, kps = jt.blob_localization_batch(np.random.default_rng(0), jh.tiny_test_config(), 2)
    targets, weights = jt.gaussian_target_heatmaps(jh.tiny_test_config(), kps)
    opt_j = jt.make_optimizer()
    step_j = jax.jit(jt.make_train_step(jh.tiny_test_config(), opt_j, jnp.float32))
    params = _jax_tree(_model())
    state = opt_j.init(params)
    ref = []
    for _ in range(JAX_STEPS):
        params, state, loss = step_j(params, state, imgs, targets, weights)
        ref.append(float(loss))

    model = _model()
    opt = torch.optim.AdamW(tt.trained_tensors(model), lr=1e-3, weight_decay=1e-4,
                            capturable=True)
    step = tt.make_train_step(model, opt, torch.float32)
    batch = (torch.from_numpy(np.asarray(imgs).transpose(0, 3, 1, 2).copy()),
             torch.from_numpy(np.asarray(targets).transpose(0, 3, 1, 2).copy()),
             torch.from_numpy(np.array(weights)))
    got = [float(step(*batch)) for _ in range(JAX_STEPS)]
    assert [(k["warmups"], k["replays"]) for k in step.stats()] == [(2, JAX_STEPS - 2)]
    np.testing.assert_allclose(got, ref, rtol=JAX_LOSS_RTOL)
