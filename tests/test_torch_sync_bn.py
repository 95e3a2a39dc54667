"""Synchronized train-mode BN's merge (`models.layers.merge_bn_stats`), in
one process with no group: each rank's local two-pass statistics, as
`SyncBNStatRecorder.observe` computes them before its all-gather, stacked
as the gathered rows, then merged by Chan's formula.

Tolerances and why:
* One part of share 1 is the identity: values and gradients bit-equal to
  `BNStatRecorder.observe` (what phase 18's one-rank gate needs).
* Equal parts (2 and 4) and unequal ones: within 1e-6 relative of the whole
  batch's statistics in f64 (f32 sums over 8 x 6 x 5 values), and within
  2e-6 of the JAX package's `jnp.mean` / `jnp.var` over the whole batch in
  f32, which XLA's psums give the sharded JAX step.
* A channel of mean 1e3 and spread 1e-2: the merged variance within 1e-3
  relative of f64. E[x^2] - E[x]^2 in f32 misses that bound by orders of
  magnitude (its cancellation leaves f32's rounding of 1e6), and Chan's
  merge over the f32 part means without their residuals lies over 10x
  further from f64 than the merge with them.
* Gradients through the merge against autograd of the whole batch's
  two-pass statistics in f64: relative norm 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupose.models.layers as jl
from tpupose_torch.models.layers import BNStatRecorder, merge_bn_stats

torch.set_num_threads(1)
N, C, H, W = 8, 7, 6, 5


def _batch(seed, mean=0.5, spread=2.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(mean, spread, size=(N, C, H, W)).astype(np.float32)
    x[:, 0] += rng.normal(0, 3.0, size=(N, 1, 1)).astype(np.float32)  # parts differ in mean
    return torch.from_numpy(x)


def _local(x):
    """A rank's two-pass statistics and mean deviation, as
    `SyncBNStatRecorder.observe`."""
    m = x.mean(dim=(0, 2, 3))
    dev = x - m[:, None, None]
    return m, torch.square(dev).mean(dim=(0, 2, 3)), dev.detach().mean(dim=(0, 2, 3))


def _merged(x, sizes):
    """The merge over the parts of `x` of `sizes` crops, each part's
    statistics stacked as the all-gather stacks them."""
    parts = torch.split(x, sizes)
    rows = torch.stack([torch.stack(_local(p)) for p in parts])  # (d, 3, C)
    shares = torch.tensor(sizes, dtype=torch.float32) / sum(sizes)
    return merge_bn_stats(shares, *rows.unbind(1))


def _f64(x):
    x = x.double()
    m = x.mean(dim=(0, 2, 3))
    return m, torch.square(x - m[:, None, None]).mean(dim=(0, 2, 3))


def _rel(got, ref):
    return float(((got.double() - ref).abs() / ref.abs()).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_one_part_is_bn_stat_recorder_bit_for_bit(seed):
    x = _batch(seed).requires_grad_(True)
    y = _batch(seed).requires_grad_(True)
    rng = np.random.default_rng(10 + seed)
    a, b = (torch.from_numpy(rng.normal(size=C).astype(np.float32)) for _ in range(2))
    m, v = _merged(x, [N])
    rm, rv = BNStatRecorder().observe(None, y)
    assert torch.equal(m, rm) and torch.equal(v, rv)
    (a * m + b * v).sum().backward()
    (a * rm + b * rv).sum().backward()
    assert torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("sizes", [[4, 4], [2, 2, 2, 2], [2, 6], [1, 3, 4]],
                         ids=["2_equal", "4_equal", "2_unequal", "3_unequal"])
def test_parts_merge_to_the_whole_batch_in_f64(sizes):
    x = _batch(2)
    m, v = _merged(x, sizes)
    rm, rv = _f64(x)
    assert _rel(m, rm) <= 1e-6 and _rel(v, rv) <= 1e-6, (_rel(m, rm), _rel(v, rv))


@pytest.mark.parametrize("d", [2, 4])
def test_parts_merge_to_jax_whole_batch_statistics(d):
    x = _batch(3)
    m, v = _merged(x, [N // d] * d)
    jm, jv = jl.BNStatRecorder().observe({}, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    jm, jv = (torch.from_numpy(np.array(t)).double() for t in (jm, jv))
    assert _rel(m, jm) <= 2e-6 and _rel(v, jv) <= 2e-6, (_rel(m, jm), _rel(v, jv))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_ill_conditioned_channel_keeps_its_variance(d):
    x = _batch(4, mean=1e3, spread=1e-2)
    x[:, 0] = x[:, 1]  # no part-to-part offset: the spread is 1e-2 throughout
    _, v = _merged(x, [N // d] * d)
    _, rv = _f64(x)
    assert _rel(v, rv) <= 1e-3, _rel(v, rv)
    # the one-pass formula over the same parts, merged as sums: cancellation
    naive = torch.stack([(torch.square(p).mean(dim=(0, 2, 3)) - torch.square(p.mean(dim=(0, 2, 3))))
                         for p in torch.split(x, N // d)]).mean(dim=0)
    assert _rel(naive, rv) > 1e-1, _rel(naive, rv)
    if d > 1:  # Chan's merge over the f32 part means alone loses their spread
        rows = torch.stack([torch.stack(_local(p)) for p in torch.split(x, N // d)])
        means, variances, residuals = rows.unbind(1)
        _, plain = merge_bn_stats(torch.full((d,), 1 / d), means, variances,
                                  torch.zeros_like(residuals))
        assert _rel(plain, rv) > 10 * _rel(v, rv), (_rel(plain, rv), _rel(v, rv))


@pytest.mark.parametrize("sizes", [[4, 4], [2, 2, 2, 2], [2, 6]],
                         ids=["2_equal", "4_equal", "2_unequal"])
def test_gradients_through_the_merge_equal_whole_batch_f64(sizes):
    x = _batch(5)
    rng = np.random.default_rng(6)
    a, b = (torch.from_numpy(rng.normal(size=C)) for _ in range(2))
    xf = x.clone().requires_grad_(True)
    m, v = _merged(xf, sizes)
    (a.float() * m + b.float() * v).sum().backward()
    xd = x.double().requires_grad_(True)
    rm, rv = _f64(xd)
    (a * rm + b * rv).sum().backward()
    err = float(torch.linalg.vector_norm(xf.grad.double() - xd.grad)
                / torch.linalg.vector_norm(xd.grad))
    assert err <= 1e-5, err
