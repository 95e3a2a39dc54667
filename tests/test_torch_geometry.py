"""tpupose_torch.geometry against tpupose.geometry on the same numpy inputs.

Tolerances: both sides compute in f32 with different summation orders (and
LAPACK vs XLA inverses for the calibration), so values agree to f32
rounding relative to their scale: rtol 1e-5 on pixels and metres, 1e-4 on
fundamental matrices (products of inverses). Triangulated points agree to
2e-3 m: the smallest-eigenvector solve amplifies f32 rounding of the
normal matrix by its conditioning, and on the noisy, time-weighted fixture
each f32 side lies up to 0.7 mm from the f64 solution.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpupose.geometry as jg
import tpupose.geometry.triangulation as jtri
import tpupose_torch.geometry as tg
import tpupose_torch.geometry.triangulation as ttri
from tests.helpers import make_rig, project_np, random_skeletons

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def rigs():
    P, K, RT = make_rig(num_cameras=4)
    return jg.make_camera_set(P, K, RT, 1280, 720), tg.make_camera_set(P, K, RT, 1280, 720)


def test_camera_set_matches(rigs):
    jrig, trig = rigs
    for name in ("P", "K", "RT", "rk_inv", "center", "size"):
        np.testing.assert_allclose(getattr(trig, name).numpy(),
                                   np.asarray(getattr(jrig, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    F_j, F_t = np.asarray(jrig.F), trig.F.numpy()
    off = ~np.eye(4, dtype=bool)
    scale = np.abs(F_j[off]).reshape(-1, 9).max(-1)[:, None, None]
    np.testing.assert_allclose(F_t[off] / scale, F_j[off] / scale, atol=1e-4)
    # a camera with itself: zero up to f32 rounding on both sides
    assert np.abs(F_t[~off]).max() < 1e-6 * scale.max()
    assert np.abs(F_j[~off]).max() < 1e-6 * scale.max()


def test_fundamental_nudge_on_exact_zero():
    K = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    RT = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32),
                 (2, 1, 1))
    np.testing.assert_array_equal(tg.fundamental_matrices(K, RT).numpy(),
                                  np.asarray(jg.fundamental_matrices(K, RT)))


def test_projection_and_rays(rigs):
    jrig, trig = rigs
    rng = np.random.default_rng(0)
    pts = random_skeletons(rng, n_people=3)  # (3, J, 3)
    ref = np.asarray(jg.project_points(jrig.P[1], pts))
    got = tg.project_points(trig.P[1], _t(pts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, project_np(trig.P[1].numpy(), pts), rtol=1e-4)

    pix = rng.uniform(0, 1000, size=(2, 17, 2)).astype(np.float32)
    ref = np.asarray(jg.back_project_rays(jrig.rk_inv[2], pix))
    got = tg.back_project_rays(trig.rk_inv[2], _t(pix)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)

    origin = np.asarray(jrig.center)[:, None, :]
    pts3 = pts[0][None]
    ref = np.asarray(jg.line_point_distance_3d(origin, jnp.asarray(ref[0])[None], pts3))
    got = tg.line_point_distance_3d(_t(origin), _t(got[0])[None], _t(pts3)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    p1, d1, p2, d2 = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(
        tg.line_line_distance_3d(_t(p1), _t(d1), _t(p2), _t(d2)).numpy(),
        np.asarray(jg.line_line_distance_3d(p1, d1, p2, d2)), rtol=1e-5, atol=1e-6)


def test_epipolar_matrix_and_batch(rigs):
    jrig, trig = rigs
    rng = np.random.default_rng(1)
    pts3d = random_skeletons(rng, n_people=2)
    poses = np.stack([
        np.stack([project_np(np.asarray(jrig.P[c]), p) for c in range(4)])
        for p in pts3d
    ]).astype(np.float32)  # (2, V, J, 2)
    poses[1] += rng.normal(scale=20.0, size=poses[1].shape).astype(np.float32)
    valid = np.array([[True, True, False, True], [True, True, True, True]])
    d_t, m_t = tg.epipolar_distance_matrix(trig.F, _t(poses), valid=_t(valid))
    for b in range(2):
        d_j, m_j = jg.epipolar_distance_matrix(jrig.F, jnp.asarray(poses[b]),
                                              valid=jnp.asarray(valid[b]))
        np.testing.assert_allclose(d_t[b].numpy(), np.asarray(d_j), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(m_t[b].numpy(), np.asarray(m_j), rtol=1e-4, atol=1e-3)
    ref = np.asarray(jg.epipolar_distance_directed(jrig.F[0, 1], poses[0, 0], poses[0, 1]))
    got = tg.epipolar_distance_directed(trig.F[0, 1], _t(poses[0, 0]), _t(poses[0, 1]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)


def test_adjugate_and_eigvec():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(6, 8, 4)).astype(np.float32)
    M = np.einsum("nra,nrc->nac", A, A)
    adj_j, det_j = jtri.adj4x4(jnp.asarray(M))
    adj_t, det_t = ttri.adj4x4(_t(M))
    np.testing.assert_allclose(adj_t.numpy(), np.asarray(adj_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(det_t.numpy(), np.asarray(det_j), rtol=1e-5)
    np.testing.assert_allclose(ttri.inv4x4(_t(M)).numpy(),
                               np.asarray(jtri.inv4x4(jnp.asarray(M))), rtol=1e-4, atol=1e-4)
    v_j = np.asarray(jtri._smallest_eigvec_4x4(jnp.asarray(M)))
    v_t = ttri._smallest_eigvec_4x4(_t(M)).numpy()
    # same direction up to sign
    np.testing.assert_allclose(np.abs(np.sum(v_j * v_t, -1)), 1.0, atol=1e-5)
    assert ttri.TIME_WEIGHT_REL_FLOOR == jtri.TIME_WEIGHT_REL_FLOOR == 1e-2


def test_triangulate_joints_batched(rigs):
    jrig, trig = rigs
    rng = np.random.default_rng(3)
    pts3d = random_skeletons(rng, n_people=3)
    poses = np.stack([
        np.stack([project_np(np.asarray(jrig.P[c]), p) for c in range(4)])
        for p in pts3d
    ]).astype(np.float32)
    poses += rng.normal(scale=0.5, size=poses.shape).astype(np.float32)
    weights = np.exp(-5.0 * rng.integers(0, 3, size=(3, 4))).astype(np.float32)
    keep = rng.uniform(size=(3, 4, 17)) > 0.3
    keep[:, :2] = True
    keep[2, :, 5] = False  # one joint with no views -> fallback
    keep[2, 0, 5] = True
    fallback = rng.normal(size=(3, 17, 3)).astype(np.float32)
    got, n_t = tg.triangulate_joints(trig.P, _t(poses), _t(weights), _t(keep),
                                     fallback=_t(fallback))
    for b in range(3):
        ref, n_j = jg.triangulate_joints(jrig.P, poses[b], weights[b], keep[b],
                                         fallback=fallback[b])
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=2e-3)
        np.testing.assert_array_equal(n_t[b].numpy(), np.asarray(n_j))
    np.testing.assert_allclose(got[2, 5].numpy(), fallback[2, 5])


def test_pairwise_top_down_and_fuse(rigs):
    jrig, trig = rigs
    rng = np.random.default_rng(4)
    pts3d = random_skeletons(rng, n_people=1)[0]
    poses = np.stack([project_np(np.asarray(jrig.P[c]), pts3d)
                      for c in range(4)]).astype(np.float32)
    ref = np.asarray(jg.triangulate_pairwise(jrig.P[0], jrig.P[2], poses[0], poses[2]))
    got = tg.triangulate_pairwise(trig.P[0], trig.P[2], _t(poses[0]), _t(poses[2]))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)

    # per-view noise of distinct scales, so one pair clearly wins
    noisy = poses + rng.normal(size=poses.shape).astype(np.float32) * np.float32(
        [[[1.0]], [[6.0]], [[0.5]], [[3.0]]])
    w2d = rng.uniform(size=(4, 17)).astype(np.float32)
    vv = np.array([True, False, True, True])
    pj, wj = jg.triangulate_top_down(jrig.P, jnp.asarray(noisy), jnp.asarray(w2d),
                                     jnp.asarray(vv))
    pt, wt = tg.triangulate_top_down(trig.P, _t(noisy), _t(w2d), _t(vv))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6)

    pts = rng.normal(size=(3, 17, 3)).astype(np.float32)
    pv = rng.uniform(size=(3, 17)) > 0.3
    w = rng.uniform(size=(3, 17)).astype(np.float32)
    costs = rng.uniform(1, 2, size=3).astype(np.float32)
    ref = jg.fuse_pairwise_humans(pts, pv, w, costs)
    got = tg.fuse_pairwise_humans(_t(pts), _t(pv), _t(w), _t(costs))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
