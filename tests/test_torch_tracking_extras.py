"""The port's off-path tracking and matcher pieces against the JAX
package's, on the same inputs made with numpy:

* `tracking.filters` (One-Euro, the constant-acceleration Kalman filter)
  and `ops.{affinity,matchmat}` within 1e-6 relative to each array's
  largest magnitude: both sides compute in f32, and XLA and torch round
  and order their sums differently. Relative to each entry, f32
  cancellation sets the error on small entries (the One-Euro derivative
  (x - x_prev) / dt of a random walk lies 1.8e-6 from JAX's on one entry
  of 1.47, 2.6e-6 absolute). `pairwise_affinity` (a sigmoid of z-scored
  squared distances) is held within 1e-6 of an f64 computation, and so
  within 2e-6 of JAX's, which lies on the other side of it (measured:
  port 5.8e-7, JAX 7.9e-7 from f64, 1.37e-6 apart);
  `proj2dpam` runs the same number of iterations (read on the JAX side as
  the smallest `max_iter` whose result equals the full run's).
* `tracking.bip`: the same partition (the LP is solved by the same scipy
  on affinities that agree to f32 rounding), and `solve_clique_partition`
  exactly the JAX package's on the same matrix.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpupose.ops.affinity as jaff
import tpupose.ops.matchmat as jmm
import tpupose.tracking.bip as jbip
import tpupose.tracking.filters as jfil
from tpupose.data.synthetic import make_scene
from tpupose.geometry import make_camera_set
import tpupose_torch.ops as tops
import tpupose_torch.ops.matchmat as tmm
import tpupose_torch.tracking.bip as tbip
import tpupose_torch.tracking.filters as tfil

torch.set_num_threads(1)
REL = 1e-6


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def test_one_euro_matches_jax():
    rng = np.random.default_rng(0)
    signal = rng.normal(size=(40, 4, 3)).cumsum(0).astype(np.float32)
    js, ts = jfil.one_euro_init((4, 3)), tfil.one_euro_init((4, 3))
    for t in range(40):
        stamp = t / 25.0 if t != 7 else 6 / 25.0  # one repeated timestamp
        js, jy = jfil.one_euro_apply(js, jnp.asarray(signal[t]), stamp)
        ts, ty = tfil.one_euro_apply(ts, torch.as_tensor(signal[t]), stamp)
        _close(ty, jy)
        for a, b in zip(ts, js):
            _close(a, b)
    jf, tf = jfil.OneEuroFilter(mincutoff=0.8, beta=0.4), tfil.OneEuroFilter(mincutoff=0.8, beta=0.4)
    for t in range(40):
        assert tf(float(signal[t, 0, 0]), t / 25.0) == jf(float(signal[t, 0, 0]), t / 25.0)
    with pytest.raises(ValueError):
        tfil.OneEuroFilter(freq=0)


def test_kalman_matches_jax():
    rng = np.random.default_rng(1)
    start = rng.normal(size=(5, 17, 3)).astype(np.float32)
    for jm, tm in zip(jfil.kalman_matrices(), tfil.kalman_matrices()):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    js, ts = jfil.kalman_init(jnp.asarray(start)), tfil.kalman_init(torch.as_tensor(start))
    for t in range(20):
        js, jp = jfil.kalman_predict(js)
        ts, tp = tfil.kalman_predict(ts)
        _close(tp, jp)
        meas = (start + 0.04 * t + rng.normal(scale=0.01, size=start.shape)).astype(np.float32)
        js = jfil.kalman_correct(js, jnp.asarray(meas))
        ts = tfil.kalman_correct(ts, torch.as_tensor(meas))
        _close(ts.x, js.x)
        _close(ts.P, js.P)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_affinities_match_jax(metric):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(6, 4, 8)).astype(np.float32)
    g = rng.normal(size=(9, 4, 8)).astype(np.float32)
    d = rng.uniform(0, 50, size=(6, 9)).astype(np.float32)
    _close(tops.embedding_affinity(q, g, metric), jaff.embedding_affinity(q, g, metric))
    _close(tops.pairwise_sq_distances(q, g), jaff.pairwise_sq_distances(q, g))
    got = tops.pairwise_affinity(q, g)
    q64, g64 = q.reshape(6, -1).astype(np.float64), g.reshape(9, -1).astype(np.float64)
    d64 = ((q64[:, None] - g64[None]) ** 2).sum(-1)
    z = -(d64 - d64.mean()) / (d64.std() + 1e-5)
    _close(got, 1.0 / (1.0 + np.exp(-5.0 * z)))
    _close(got, jaff.pairwise_affinity(q, g), rel=2 * REL)
    _close(tops.normalized_geometry_affinity(d), jaff.normalized_geometry_affinity(d))


def test_transform_closure_matches_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 9):
        a = rng.uniform(size=(n, n))
        x = ((a + a.T) / 2 > 0.6) | np.eye(n, dtype=bool)
        got = tops.transform_closure(torch.as_tensor(x))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jmm.transform_closure(x)))
    chain = np.eye(6, dtype=bool)
    for i in range(5):  # 0-1-2-3-4-5: needs every doubling step
        chain[i, i + 1] = chain[i + 1, i] = True
    np.testing.assert_array_equal(tops.transform_closure(torch.as_tensor(chain)).numpy(),
                                  np.asarray(jmm.transform_closure(chain)))


def test_proj2pav_matches_jax():
    rng = np.random.default_rng(4)
    for y in ([0.5, 0.3, -0.2], [2.0, 0.0], [0.8, 0.8], [0.0, 0.0, 0.0],
              *rng.uniform(-0.5, 1.5, size=(6, 7)).tolist()):
        y = np.asarray(y, np.float32)
        _close(tops.proj2pav(torch.as_tensor(y)), jmm.proj2pav(jnp.asarray(y)))


def _jax_iterations(y, tol, max_iter):
    full = np.asarray(jmm.proj2dpam(jnp.asarray(y), tol=tol, max_iter=max_iter))
    return next(k for k in range(1, max_iter + 1)
                if np.array_equal(np.asarray(jmm.proj2dpam(jnp.asarray(y), tol=tol,
                                                           max_iter=k)), full))


@pytest.mark.parametrize("shape,tol,max_iter", [((5, 4), 1e-4, 10), ((6, 6), 1e-4, 10),
                                                ((4, 7), 1e-6, 6)])
def test_proj2dpam_matches_jax(shape, tol, max_iter):
    rng = np.random.default_rng(5)
    y = rng.uniform(0, 1.5, size=shape).astype(np.float32)
    got, iters = tmm.proj2dpam_iterations(torch.as_tensor(y), tol=tol, max_iter=max_iter)
    _close(got, jmm.proj2dpam(jnp.asarray(y), tol=tol, max_iter=max_iter))
    assert iters == _jax_iterations(y, tol, max_iter)
    torch.testing.assert_close(tops.proj2dpam(y, tol=tol, max_iter=max_iter), got,
                               rtol=0, atol=0)


def test_clique_partition_equals_jax():
    rng = np.random.default_rng(6)
    for n in (0, 1, 2, 5, 7):
        a = rng.normal(size=(n, n))
        aff = (a + a.T) / 2
        if n > 2:
            aff[0, 1] = aff[1, 0] = np.inf
            aff[0, 2] = aff[2, 0] = -np.inf
        assert tbip.solve_clique_partition(aff) == jbip.solve_clique_partition(aff)


@pytest.mark.parametrize("seed", [4, 7])
def test_bip_matching_equals_jax(seed):
    scene = make_scene(num_frames=1, num_cameras=3, num_actors=3, noise_px=1.0, seed=seed)
    rig = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    cam_of = np.repeat(np.arange(3), 3)
    poses = np.stack([scene.detections[0, c, a] for c in range(3) for a in range(3)])
    ref = jbip.bip_matching(np.asarray(rig.F), cam_of, poses, threshold=40.0)
    got = tbip.bip_matching(np.asarray(rig.F), cam_of, poses, threshold=40.0)
    assert got == ref
    assert sorted(map(tuple, got)) == [(0, 3, 6), (1, 4, 7), (2, 5, 8)]
