"""Save and resume with `tpupose_torch.models.checkpoint`, on the tiny HRNet
on the CPU: float, BN-folded and quantized state_dicts and an optimizer's
state come back bit for bit, a resumed run takes the same next step as the
run it was saved from, and `like` refuses a checkpoint of another shape."""
import numpy as np
import pytest
import torch

import tpupose_torch.models.hrnet as th
import tpupose_torch.models.quantize as tq
import tpupose_torch.models.train as tt
from tpupose_torch.models.checkpoint import restore_params, save_params
from tpupose_torch.models.layers import fold_batchnorm
from tpupose_torch.ops.int8_conv import pack_weight

torch.set_num_threads(1)


def _model(seed=0, cfg=None):
    return th.hrnet_init(cfg or th.tiny_test_config(), torch.Generator().manual_seed(seed))


def _images(seed=0):
    return torch.rand((2, 3, 96, 64), generator=torch.Generator().manual_seed(seed))


def _variant(kind, seed):
    """A tiny HRNet (BN statistics re-estimated on random images) as it is,
    folded, or folded and quantized."""
    model = _model(seed)
    tq.calibrate_bn_stats(lambda b: model(b, torch.float32), _images(seed))
    if kind == "float":
        return model
    model = fold_batchnorm(model)
    if kind == "folded":
        return model
    return tq.quantize_hrnet(model, model.cfg, _images(seed), compute_dtype=torch.float32)


def _assert_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("kind", ["float", "folded", "quantized"])
def test_state_dict_round_trip_is_exact(tmp_path, kind):
    saved = _variant(kind, 1)
    path = str(tmp_path / "ckpt" / f"{kind}.pt")
    save_params(path, saved.state_dict())
    _assert_equal(restore_params(path), saved.state_dict())
    into = _variant(kind, 2)  # same structure, other values
    assert restore_params(path, like=into) is into
    _assert_equal(into.state_dict(), saved.state_dict())
    if kind == "quantized":
        convs = [m for m in into.modules() if isinstance(m, tq.QuantConv2d)]
        assert convs and all(c.weight_q.dtype == torch.int8 for c in convs)
        assert all(torch.equal(c.weight_k, pack_weight(c.weight_q)) for c in convs)
        x = _images(4)
        with torch.no_grad():
            assert torch.equal(into(x, torch.float32), saved(x, torch.float32))


def test_resumed_training_takes_the_same_step(tmp_path):
    """Save model and AdamW state after 3 steps, restore both into fresh
    objects, then one step from each: every tensor stays equal."""
    cfg = th.tiny_test_config()
    imgs, kps = tt.blob_localization_batch(np.random.default_rng(0), cfg, 2, device="cpu")
    targets, weights = tt.gaussian_target_heatmaps(cfg, kps)
    model = _model(5)
    opt = tt.make_optimizer(tt.trained_tensors(model))
    step = tt.make_train_step(model, opt, torch.float32)
    for _ in range(3):
        step(imgs, targets, weights)
    save_params(str(tmp_path / "model.pt"), model.state_dict())
    save_params(str(tmp_path / "opt.pt"), opt.state_dict())

    fresh = _model(6)
    restore_params(str(tmp_path / "model.pt"), like=fresh)
    fresh_opt = tt.make_optimizer(tt.trained_tensors(fresh))
    restore_params(str(tmp_path / "opt.pt"), like=fresh_opt)
    _assert_equal(fresh.state_dict(), model.state_dict())
    for (a, sa), (b, sb) in zip(opt.state.items(), fresh_opt.state.items()):
        assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    loss_a = step(imgs, targets, weights)
    loss_b = tt.make_train_step(fresh, fresh_opt, torch.float32)(imgs, targets, weights)
    assert torch.equal(loss_a, loss_b)
    _assert_equal(fresh.state_dict(), model.state_dict())


def test_restore_refuses_another_config(tmp_path):
    path = str(tmp_path / "tiny.pt")
    save_params(path, _model(0).state_dict())
    wider = _model(0, cfg=th.HRNetConfig(**{**th.tiny_test_config().__dict__, "width": 16}))
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_params(path, like=wider)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        restore_params(path, like=fold_batchnorm(_model(0)))
    with pytest.raises(ValueError, match="float64"):
        restore_params(path, like=_model(0).double())


def test_restore_refuses_another_optimizer(tmp_path):
    model = _model(0)
    opt = torch.optim.Adam(tt.trained_tensors(model))
    for p in opt.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    opt.step()
    path = str(tmp_path / "opt.pt")
    save_params(path, opt.state_dict())
    other = _model(0, cfg=th.HRNetConfig(**{**th.tiny_test_config().__dict__, "width": 16}))
    with pytest.raises(ValueError, match="exp_avg"):
        restore_params(path, like=torch.optim.Adam(tt.trained_tensors(other)))
    with pytest.raises(ValueError, match="parameter group"):
        restore_params(path, like=torch.optim.Adam(list(model.parameters())))
