"""The batched masked LAP (`tpupose_torch.ops.lap.masked_lap`, the op
`tpupose_torch::masked_lap`; kernel K3 on CUDA, its plain version here)
against `jax.vmap(tpupose.ops.lap.masked_lap)` on the same numpy inputs.

Assignments are exact: both sides run the same f32 Jonker-Volgenant steps
in the same order with first-index argmins, so they agree on ties too
(integer costs in [0, 3]). The batches hold empty problems (all rows or all
columns invalid) and both orientations (R < C, R > C).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.ops.lap import masked_lap as j_masked_lap
from tpupose_torch.ops import lap

torch.set_num_threads(1)


def _problems(rng, lead, shape, ties):
    R, C = shape
    cost = (rng.integers(0, 4, size=lead + shape) if ties
            else rng.uniform(-1, 1, size=lead + shape)).astype(np.float32)
    rv = rng.uniform(size=lead + (R,)) > rng.uniform(0, 0.6, size=lead + (1,))
    cv = rng.uniform(size=lead + (C,)) > rng.uniform(0, 0.6, size=lead + (1,))
    flat_rv, flat_cv = rv.reshape(-1, R), cv.reshape(-1, C)
    flat_rv[0] = False             # an empty problem: no valid row
    flat_cv[1 % len(flat_cv)] = False  # and one with no valid column
    flat_rv[-1] = flat_cv[-1] = True   # and a full one
    return cost, rv, cv


def _jax(cost, rv, cv, maximize):
    fn = functools.partial(j_masked_lap, maximize=maximize)
    for _ in range(cost.ndim - 2):
        fn = jax.vmap(fn)
    return np.asarray(jax.jit(fn)(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv)))


@pytest.mark.parametrize("lead", [(6,), (2, 5)], ids=["B", "SxC"])
@pytest.mark.parametrize("shape,maximize,ties", [
    ((12, 4), True, False), ((16, 16), True, True), ((24, 4), False, True),
    ((4, 12), False, False), ((10, 16), False, False)])
def test_batched_masked_lap_equals_jax_vmap(lead, shape, maximize, ties):
    rng = np.random.default_rng(sum(shape) + len(lead))
    cost, rv, cv = _problems(rng, lead, shape, ties)
    got = lap.masked_lap(torch.as_tensor(cost), torch.as_tensor(rv),
                         torch.as_tensor(cv), maximize=maximize)
    assert got.shape == lead + (shape[0],) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _jax(cost, rv, cv, maximize))
    flat = got.reshape(-1, shape[0]).numpy()
    assert (flat[0] == -1).all() and (flat[1 % len(flat)] == -1).all()
    assert (flat[-1] >= 0).sum() == min(shape)


def test_vmap_equals_loop_and_broadcast_masks():
    rng = np.random.default_rng(0)
    cost, rv, cv = (torch.as_tensor(x) for x in _problems(rng, (3, 4), (5, 7), True))
    fn = functools.partial(lap.masked_lap, maximize=True)
    loop = torch.stack([torch.stack([fn(cost[s, c], rv[s, c], cv[s, c])
                                     for c in range(4)]) for s in range(3)])
    torch.testing.assert_close(torch.func.vmap(torch.func.vmap(fn))(cost, rv, cv),
                               loop, rtol=0, atol=0)
    # vmapped over the costs alone: the unbatched masks are expanded
    one = torch.func.vmap(fn, in_dims=(0, None, None))(cost[:, 0], rv[0, 0], cv[0, 0])
    torch.testing.assert_close(
        one, torch.stack([fn(cost[s, 0], rv[0, 0], cv[0, 0]) for s in range(3)]),
        rtol=0, atol=0)
    # vmapped over an inner dimension, with (R,) masks broadcast by masked_lap
    inner = torch.func.vmap(lambda c: fn(c, rv[0, 0], cv[0, 0]), in_dims=1)(cost)
    torch.testing.assert_close(inner, torch.stack(
        [fn(cost[:, c], rv[0, 0], cv[0, 0]) for c in range(4)]), rtol=0, atol=0)


def test_op_passes_opcheck():
    rng = np.random.default_rng(1)
    for lead, shape in (((3,), (4, 6)), ((2, 2), (6, 3))):
        cost, rv, cv = (torch.as_tensor(x) for x in _problems(rng, lead, shape, False))
        torch.library.opcheck(lap._masked_lap_op, (cost, rv, cv, True))


def test_cuda_wrapper_refuses_cpu_and_wide_problems():
    cost = torch.zeros(2, 3, 4)
    rv, cv = torch.ones(2, 3, dtype=torch.bool), torch.ones(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lap.masked_lap_cuda(cost, rv, cv)
    # the plain version still reads the device on the host per JV step
    before = lap.host_syncs
    lap.masked_lap(cost, rv, cv)
    assert lap.host_syncs - before >= 2 * 2 * 3
