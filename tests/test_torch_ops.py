"""tpupose_torch.ops (LAP, smoothing, image resampling, NMS) against
tpupose.ops and scipy on the same numpy inputs.

Tolerances: assignments, keep sets and indices are exact. The LAP runs the
same f32 arithmetic in the same order on both sides, so on tie-free
random costs the assignments are identical. Smoothing and the f32
resample agree to f32 rounding (rtol 1e-6 / 1e-5). The bf16 resample is
exact: every output is a sum of at most two products of bf16 values, each
exact in f32, rounded once to bf16 on both sides.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter1d
from scipy.optimize import linear_sum_assignment

import tpupose.ops as jops
import tpupose_torch.ops as tops
from tpupose.ops.image import letterbox_resize as j_letterbox
from tpupose_torch.ops import lap as tlap

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("n", [1, 3, 8, 16])
def test_solve_lap_matches_jax_and_scipy(n):
    rng = np.random.default_rng(n)
    solve = jax.jit(jops.solve_lap)
    for _ in range(4):
        cost = rng.uniform(-10, 10, size=(n, n + 2)).astype(np.float32)
        row_j, col_j = solve(cost)
        row_t, col_t = tops.solve_lap(_t(cost))
        np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
        np.testing.assert_array_equal(row_t.numpy(), np.asarray(row_j))
        r, c = linear_sum_assignment(cost)
        assert abs(cost[np.arange(n), col_t.numpy()].sum() - cost[r, c].sum()) < 1e-3


def test_lap_degenerate_ties_optimal():
    rng = np.random.default_rng(0)
    for _ in range(4):
        cost = rng.integers(0, 3, size=(10, 10)).astype(np.float32)
        _, col = tops.solve_lap(_t(cost))
        r, c = linear_sum_assignment(cost)
        assert cost[np.arange(10), col.numpy()].sum() == cost[r, c].sum()


@pytest.mark.parametrize("shape,maximize", [((12, 4), True), ((4, 12), False),
                                            ((24, 4), False), ((8, 8), True)])
def test_masked_lap_matches_jax(shape, maximize):
    rng = np.random.default_rng(sum(shape))
    for _ in range(4):
        cost = rng.uniform(0, 1, size=shape).astype(np.float32)
        rv = rng.uniform(size=shape[0]) > 0.3
        cv = rng.uniform(size=shape[1]) > 0.3
        ref = np.asarray(jops.masked_lap(cost, jnp.asarray(rv), jnp.asarray(cv),
                                         maximize=maximize))
        got = tops.masked_lap(_t(cost), _t(rv), _t(cv), maximize=maximize)
        np.testing.assert_array_equal(got.numpy(), ref)
        # the real block is solved optimally (scipy on the valid block)
        block = cost[np.ix_(rv, cv)]
        if block.size:
            r, c = linear_sum_assignment(block, maximize=maximize)
            got_sum = sum(cost[i, j] for i, j in enumerate(got.numpy()) if j >= 0)
            assert abs(got_sum - block[r, c].sum()) < 1e-4


def test_pad_cost_equals_jax():
    assert tops.PAD_COST == jops.PAD_COST == tlap.PAD_COST == 1e6


def test_lap_counts_host_reads():
    before = tlap.host_syncs
    tops.solve_lap(_t(np.random.default_rng(0).uniform(size=(3, 5)).astype(np.float32)))
    assert tlap.host_syncs - before >= 6  # >= 1 search + 1 augment test per row


@pytest.mark.parametrize("sigma", [0.3, 0.6, 0.8])
def test_smooth_last_matches_jax_and_scipy(sigma):
    rng = np.random.default_rng(int(sigma * 10))
    hist = rng.normal(size=(5, 12, 17, 3)).astype(np.float32)
    counts = np.array([1, 2, 3, 7, 12], np.int32)
    got = tops.smooth_last(_t(hist), _t(counts), sigma).numpy()
    for b, n in enumerate(counts):
        ref = np.asarray(jops.smooth_last(jnp.asarray(hist[b]), jnp.int32(n), sigma))
        np.testing.assert_allclose(got[b], ref, rtol=1e-6, atol=1e-6)
        sp = gaussian_filter1d(hist[b, :n], sigma=sigma, axis=0, mode="reflect")[-1]
        np.testing.assert_allclose(got[b], sp, rtol=1e-4, atol=1e-5)
        single = tops.smooth_last(_t(hist[b]), int(n), sigma).numpy()
        np.testing.assert_allclose(single, got[b], rtol=1e-6, atol=1e-7)
    ref = np.asarray(jops.smooth_last_pose(jnp.asarray(hist[3]), jnp.int32(7), sigma, 0.8))
    got = tops.smooth_last_pose(_t(hist[3]), 7, sigma, 0.8).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_and_resize_matches_jax(dtype):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, size=(2, 40, 56, 3)).astype(np.float32) / 255.0
    boxes = np.array([[[-5, 3, 30, 38], [10.3, 2.2, 50.9, 39.5]],
                      [[0, 0, 56, 40], [20, 10, 70, 60]]], np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    got = tops.crop_and_resize(_t(img).to(tdt), _t(boxes), (24, 16)).float().numpy()
    for i in range(2):
        ref = np.asarray(jops.crop_and_resize(jnp.asarray(img[i]).astype(jdt),
                                              jnp.asarray(boxes[i]), (24, 16)),
                         np.float32)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got[i], ref)
        else:
            np.testing.assert_allclose(got[i], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_and_letterbox_match_jax(dtype):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, size=(2, 36, 64, 3)).astype(np.float32) / 255.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    ref = np.asarray(jops.resize_bilinear(jnp.asarray(img).astype(jdt), (32, 32)), np.float32)
    got = tops.resize_bilinear(_t(img).to(tdt), (32, 32)).float().numpy()
    ref_l = np.asarray(j_letterbox(jnp.asarray(img).astype(jdt), 32), np.float32)
    got_l = tops.letterbox_resize(_t(img).to(tdt), 32).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_l, ref_l)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_l, ref_l, rtol=1e-5, atol=1e-6)


def test_nms_matches_jax_with_ties():
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 60, size=(3, 16, 2))
    wh = rng.uniform(5, 30, size=(3, 16, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(size=(3, 16)).astype(np.float32)
    scores[:, 5] = scores[:, 9]  # planted score ties: lower index first
    boxes[:, 9] = boxes[:, 5] + 1.0
    valid = scores > 0.2
    got = tops.nms(_t(boxes), _t(scores), _t(valid), 0.4).numpy()
    for i in range(3):
        ref = np.asarray(jops.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                  jnp.asarray(valid[i]), 0.4))
        np.testing.assert_array_equal(got[i], ref)
    np.testing.assert_allclose(tops.iou_matrix(_t(boxes[0]), _t(boxes[1])).numpy(),
                               np.asarray(jops.iou_matrix(boxes[0], boxes[1])),
                               rtol=1e-6, atol=1e-7)
