"""The port's plain heatmap decode (the CUDA kernel's plain version) against
tpupose's XLA decode (all three refinement modes) and its Pallas kernel in
interpret mode (raw and quarter), plus the dispatch rule.

The port reads NCHW (N, J, H, W); the JAX functions read NHWC, so the
fixtures are made NHWC with numpy and transposed for the port. Indices and
scores must be exactly equal, and so must the coordinates: the plain
version maps through the box in the JAX order (x0 + px / W * bw), one
IEEE f32 operation at a time on both sides.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpupose.ops.heatmap import decode_heatmaps as j_decode
from tpupose.ops.heatmap import expand_box_to_aspect as j_expand
from tpupose.ops.pallas_heatmap import decode_heatmaps_pallas
import tpupose_torch.ops.heatmap as th

torch.set_num_threads(1)


def _random_heat(seed, n=3, hh=16, wh=12, j=5):
    # as tests/test_pallas_heatmap.py: noise plus one planted peak per joint
    rng = np.random.default_rng(seed)
    heat = rng.normal(scale=0.1, size=(n, hh, wh, j)).astype(np.float32)
    for i in range(n):
        for k in range(j):
            y, x = rng.integers(0, hh), rng.integers(0, wh)
            heat[i, y, x, k] = 2.0 + rng.uniform()
    return heat


def _planted(seed=0):
    """Ties, plateaus and border peaks (NHWC, 6 crops x 4 joints)."""
    rng = np.random.default_rng(seed)
    heat = rng.normal(scale=0.1, size=(6, 16, 12, 4)).astype(np.float32)
    heat[0] = 0.0                              # flat -> index 0, no shift
    heat[1, :, :, 0] = 1.0                     # plateau of the max
    heat[1, 3, :, 1] = 5.0                     # all-equal row -> first column
    heat[1, 7, 4, 2] = heat[1, 2, 9, 2] = 4.0  # tie across rows -> row 2
    heat[1, 5, 8, 3] = heat[1, 5, 3, 3] = 4.0  # tie in one row -> column 3
    for k, (y, x) in enumerate([(0, 5), (15, 5), (7, 0), (7, 11)]):
        heat[2, y, x, k] = 3.0                 # border peaks: no refinement
    heat[3] = 0.0
    heat[3, 6, 6, :] = 3.0                     # interior peak with
    heat[3, 6, 7, 0] = heat[3, 6, 5, 0] = 1.0  #   equal neighbours (sign 0)
    heat[3, 6, 7, 1] = 2.5                     #   a right-leaning neighbour
    heat[3, 7, 6, 2] = 2.9                     #   an up-leaning one
    heat[4, 1, 1, :] = 3.0                     # corner-adjacent interior peak
    heat[5] = -0.5                             # negative plateau -> index 0
    heat[5, 4, 4, 1] = -0.25
    return heat


def _boxes(n, seed=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1200, size=(n, 2))
    wh = rng.uniform(20, 500, size=(n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _nchw(heat):
    return torch.as_tensor(np.ascontiguousarray(heat.transpose(0, 3, 1, 2)))


FIXTURES = {
    "random": lambda: _random_heat(0),
    "random_wide": lambda: _random_heat(1, n=4, hh=24, wh=18, j=17),
    "planted": _planted,
}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("refine", [False, True, "parabolic"])
def test_plain_decode_equals_jax_decode(fixture, refine):
    heat = FIXTURES[fixture]()
    boxes = _boxes(heat.shape[0])
    ref = np.asarray(j_decode(jnp.asarray(heat), jnp.asarray(boxes), refine=refine))
    got = th.decode_heatmaps(_nchw(heat), torch.as_tensor(boxes), refine=refine).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("refine", [False, True])
def test_plain_decode_equals_interpreted_pallas(fixture, refine):
    heat = FIXTURES[fixture]()
    boxes = _boxes(heat.shape[0], seed=2)
    ref = np.asarray(decode_heatmaps_pallas(jnp.asarray(heat), jnp.asarray(boxes),
                                            refine=refine, interpret=True))
    got = th.decode_heatmaps(_nchw(heat), torch.as_tensor(boxes), refine=refine).numpy()
    np.testing.assert_array_equal(got, ref)


def _nonfinite():
    """Non-finite planes (NHWC, 2 crops x 8 x 6 x 5 joints)."""
    inf = np.float32(np.inf)
    heat = np.random.default_rng(5).normal(scale=0.1, size=(2, 8, 6, 5)).astype(np.float32)
    heat[:, 3, 2, :] = 1.0                     # a finite interior peak
    heat[0, 3, 1, 0] = heat[0, 3, 3, 0] = -inf  # -inf left and right
    heat[0, 2, 2, 1] = heat[0, 4, 2, 1] = -inf  # -inf up and down
    heat[0, :, :, 2] = -inf                    # all -inf
    heat[0, 3, 2, 3] = inf                     # +inf peak, finite neighbours
    heat[0, 5, 4, 4] = np.nan                  # NaN counts as the largest
    heat[1, 3, 1, 0] = -inf                    # -inf on one side only
    heat[1, 3, 2, 1] = heat[1, 3, 3, 1] = inf  # +inf peak with a +inf neighbour
    heat[1, 3, 1, 2] = np.nan                  # NaN neighbour of the peak
    heat[1, 2, 2, 3] = heat[1, 4, 2, 3] = inf  # +inf above and below the peak
    heat[1, :, :, 4] = np.nan                  # all NaN
    return heat


@pytest.mark.parametrize("refine", [False, True, "parabolic"])
def test_non_finite_planes_decode_as_jax(refine):
    # Quarter refinement next to two -inf (or +inf) neighbours takes the
    # sign of inf - inf = NaN: jnp.sign gives NaN, torch.sign gives 0.
    heat = _nonfinite()
    boxes = np.tile(np.float32([[10, 20, 70, 100]]), (2, 1))
    ref = np.asarray(j_decode(jnp.asarray(heat), jnp.asarray(boxes), refine=refine))
    got = th.decode_heatmaps(_nchw(heat), torch.as_tensor(boxes), refine=refine).numpy()
    np.testing.assert_array_equal(got, ref)  # NaN equals NaN here
    if refine is True:
        assert np.isnan(got[0, 0, 0]) and np.isnan(got[0, 1, 1])


def test_planted_cases_decode_as_specified():
    heat = _planted()
    boxes = np.tile(np.float32([[0, 0, 12, 16]]), (6, 1))  # 1 px per cell
    got = th.decode_heatmaps(_nchw(heat), torch.as_tensor(boxes), refine=False).numpy()
    np.testing.assert_array_equal(got[0, :, :2], 0.0)
    assert tuple(got[1, 0, :2]) == (0.0, 0.0)
    assert tuple(got[1, 1, :2]) == (0.0, 3.0)
    assert tuple(got[1, 2, :2]) == (9.0, 2.0)
    assert tuple(got[1, 3, :2]) == (3.0, 5.0)
    assert tuple(got[5, 0]) == (0.0, 0.0, -0.5)
    assert tuple(got[5, 1, :2]) == (4.0, 4.0)
    got = th.decode_heatmaps(_nchw(heat), torch.as_tensor(boxes), refine=True).numpy()
    np.testing.assert_array_equal(got[0, :, :2], 0.0)  # border: no shift
    np.testing.assert_array_equal(got[2, :, :2], [[5, 0], [5, 15], [0, 7], [11, 7]])
    assert tuple(got[3, 0, :2]) == (6.0, 6.0)
    assert tuple(got[3, 1, :2]) == (6.25, 6.0)
    assert tuple(got[3, 2, :2]) == (6.0, 6.25)


def test_dispatch_keeps_cpu_tensors_on_the_plain_version(monkeypatch):
    from tpupose_torch import kernels

    def no_kernel(name):
        raise AssertionError("the CUDA kernel must not be reached from a CPU tensor")

    monkeypatch.setattr(kernels, "library", no_kernel)
    heat, boxes = _nchw(_random_heat(3)), torch.as_tensor(_boxes(3))
    before = th.launches
    for refine in (False, "quarter", "parabolic"):
        torch.testing.assert_close(th.decode_heatmaps_auto(heat, boxes, refine),
                                   th.decode_heatmaps(heat, boxes, refine),
                                   rtol=0, atol=0)
    assert th.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        th.decode_heatmaps_cuda(heat, boxes)
    with pytest.raises(ValueError, match="refinement"):
        th.refine_mode("cubic")


def test_expand_box_matches_jax():
    boxes = _boxes(7, seed=4)
    boxes[3, 2] = boxes[3, 0] + 400.0  # wide box grows in height
    ref = np.asarray(j_expand(jnp.asarray(boxes), 384 / 288))
    got = th.expand_box_to_aspect(torch.as_tensor(boxes), 384 / 288).numpy()
    np.testing.assert_array_equal(got, ref)
