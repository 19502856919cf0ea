"""The two-view toolbox of the PyTorch port (models/sfm) against the JAX
package on the CPU, in float64, on the scenes of test_mvg.py,
test_five_point.py, test_optimal_triangulation.py and test_autocalib.py.

Tolerances: F, E and H equal up to sign within 1e-9 (an SVD's singular
vectors have a free sign in both packages); the 7-point roots and the
5-point candidates are compared as sets (their order is the eigensolver's),
each JAX candidate within 1e-9 of one of the port's up to sign; corrected
points within 1e-9; K within 1e-8 (relative to |K|, whose entries are
~500). RANSAC: given the JAX package's samples (drawn here from its key,
as its ``ransac`` draws them), the same best hypothesis and inliers.

The JAX package's 7-point interpolates the determinant's cubic with a wrong
c3 (ROADMAP C.3), so its candidates are not rank 2. The port's are held to
``_j_fundamental_7point``, the JAX function with that coefficient
corrected and nothing else changed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import so3 as jso3
from surikatoko_tpu.models.sfm import autocalib as jcal
from surikatoko_tpu.models.sfm import five_point as jfp
from surikatoko_tpu.models.sfm import mvg as jmvg
from surikatoko_tpu.models.sfm import optimal_triangulation as jot
from surikatoko_tpu.models.sfm import ransac as jransac
from surikatoko_tpu_torch.models.sfm import autocalib as tcal
from surikatoko_tpu_torch.models.sfm import five_point as tfp
from surikatoko_tpu_torch.models.sfm import mvg as tmvg
from surikatoko_tpu_torch.models.sfm import optimal_triangulation as tot
from surikatoko_tpu_torch.models.sfm import ransac as transac

from test_autocalib import K_GT, plane_homographies
from test_mvg import two_view_scene

torch.set_num_threads(2)

TOL = 1e-9


def _t(a):
    return torch.as_tensor(np.array(a))


def _upto_sign(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(min(np.abs(a - b).max(), np.abs(a + b).max()))


def _scene(seed, **kw):
    x1, x2, R, t, X = two_view_scene(np.random.default_rng(seed), **kw)
    return np.asarray(x1), np.asarray(x2), np.asarray(R), np.asarray(t), X


def _jax_samples(key, n, s, iterations):
    return torch.as_tensor(np.array(jax.vmap(
        lambda k: jax.random.choice(k, n, (s,), replace=False))(
            jax.random.split(key, iterations))), dtype=torch.int64)


def test_torch_ransac_iterations_count():
    for args in ((0.99, 0.5, 8), (0.999, 0.3, 8), (0.99, 0.0, 5),
                 (0.99, 1.0, 3)):
        assert (transac.ransac_iterations_count(*args)
                == jransac.ransac_iterations_count(*args))
    assert 1100 < transac.ransac_iterations_count(0.99, 0.5, 8) < 1250


def test_torch_ransac_draws_distinct_indices():
    g = torch.Generator().manual_seed(3)
    s = transac.draw_samples(g, 9, 5, 200)
    assert s.shape == (200, 5) and s.dtype == torch.int64
    assert all(len(set(r.tolist())) == 5 for r in s)
    assert int(s.min()) >= 0 and int(s.max()) <= 8
    with pytest.raises(ValueError):
        transac.ransac(9, 5, None, None, 1.0)


@pytest.mark.parametrize("seed", [20260817, 3])
def test_torch_homography_dlt_and_decomposition_equal_jax(seed):
    x1, x2, R, t, _ = _scene(seed, planar=True)
    m = np.ones(len(x1), bool)
    m[::7] = False
    Hj = np.asarray(jmvg.homography_dlt(jnp.asarray(x1), jnp.asarray(x2),
                                        jnp.asarray(m)))
    Ht = tmvg.homography_dlt(_t(x1), _t(x2), _t(m)).numpy()
    assert _upto_sign(Ht, Hj) < TOL
    # a batch of problems gives each problem's H
    Hb = tmvg.homography_dlt(_t(np.stack([x1, x2])), _t(np.stack([x2, x1])),
                             _t(np.stack([m, m])))
    np.testing.assert_allclose(Hb[0].numpy(), Ht, rtol=0, atol=TOL)
    ref = jmvg.decompose_homography_calibrated(jnp.asarray(Hj))
    out = tmvg.decompose_homography_calibrated(_t(Hj))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=TOL)
    errs = [float(np.linalg.norm(out[0][i].numpy() - R)) for i in range(4)]
    assert min(errs) < 1e-3


@pytest.mark.parametrize("seed", [20260817, 11])
def test_torch_fundamental_and_essential_equal_jax(seed):
    x1, x2, R, t, _ = _scene(seed)
    m = np.ones(len(x1), bool)
    J = tuple(jnp.asarray(a) for a in (x1, x2, m))
    T = tuple(_t(a) for a in (x1, x2, m))
    Fj = np.asarray(jmvg.fundamental_8point(*J))
    Ft = tmvg.fundamental_8point(*T)
    assert _upto_sign(Ft.numpy(), Fj) < TOL
    Ej = np.asarray(jmvg.essential_8point(*J))
    Et = tmvg.essential_8point(*T).numpy()
    assert _upto_sign(Et, Ej) < TOL
    K1 = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]])
    assert _upto_sign(
        tmvg.essential_from_fundamental(_t(Fj), _t(K1), _t(K1)).numpy(),
        np.asarray(jmvg.essential_from_fundamental(jnp.asarray(Fj),
                                                   jnp.asarray(K1),
                                                   jnp.asarray(K1)))) < TOL
    np.testing.assert_allclose(
        tmvg.sampson_distance_sq(_t(Fj), T[0], T[1]).numpy(),
        np.asarray(jmvg.sampson_distance_sq(jnp.asarray(Fj), *J[:2])),
        rtol=1e-9, atol=1e-30)
    Rj, tj = jmvg.decompose_essential_best(jnp.asarray(Ej), *J)
    Rt, tt = tmvg.decompose_essential_best(_t(Ej), *T)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=TOL)
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), t, atol=1e-6)
    assert float(torch.linalg.svdvals(Ft)[2]) < 1e-10


def test_torch_relative_pose_with_refinement_equals_jax():
    """test_relative_pose_noisy_with_refinement's scene: 100 points, half a
    pixel of noise at f = 500, the Sampson polish on."""
    rng = np.random.default_rng(20260817)
    x1, x2, R, t, _ = (np.asarray(a) for a in two_view_scene(rng, n=100))
    x1 = x1 + rng.normal(scale=1e-3, size=x1.shape)
    x2 = x2 + rng.normal(scale=1e-3, size=x2.shape)
    m = np.ones(100, bool)
    for refine in (False, True):
        ref = jmvg.relative_pose_from_correspondences(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m), refine=refine)
        out = tmvg.relative_pose_from_correspondences(_t(x1), _t(x2), _t(m),
                                                      refine=refine)
        np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=0,
                                   atol=TOL)
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(out.R.numpy() @ R.T) - 1) / 2, -1, 1)))
    assert ang < 0.5


def _j_fundamental_7point(x1, x2):
    """surikatoko_tpu/models/sfm/mvg.py's ``fundamental_7point`` with the
    cubic's c3 = (d(2) - d(1) + d(-1) - d(0) - 4 c2) / 6."""
    u, v = x1[:, 0], x1[:, 1]
    up, vp = x2[:, 0], x2[:, 1]
    A = jnp.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v,
                   jnp.ones_like(u)], axis=-1)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F1 = Vt[-1].reshape(3, 3)
    F2 = Vt[-2].reshape(3, 3)

    def d(a):
        return jnp.linalg.det(a * F1 + (1 - a) * F2)

    d0, d1, dm1, d2 = d(0.0), d(1.0), d(-1.0), d(2.0)
    c0 = d0
    c2 = (d1 + dm1) / 2.0 - c0
    c3 = (d2 - d1 + dm1 - d0 - 4 * c2) / 6.0
    c1 = d1 - c0 - c2 - c3
    roots = jnp.roots(jnp.stack([c3, c2, c1, c0]), strip_zeros=False)
    real = jnp.where(jnp.abs(roots.imag) < 1e-6, roots.real, jnp.nan)
    first_real = jnp.nanmax(jnp.where(jnp.isnan(real), -jnp.inf, real))
    alphas = jnp.where(jnp.isnan(real), first_real, real).astype(x1.dtype)
    Fs = alphas[:, None, None] * F1 + (1 - alphas[:, None, None]) * F2
    norms = jnp.sqrt(jnp.sum(Fs * Fs, axis=(1, 2)))[:, None, None]
    return Fs / jnp.maximum(norms, 1e-30)


def _match_sets(ref, out, tol=TOL):
    """Each of ``ref``'s matrices is within ``tol`` of one of ``out``'s, up
    to sign, and the counts agree."""
    assert len(ref) == len(out)
    for r in ref:
        assert min(_upto_sign(r, o) for o in out) < tol


@pytest.mark.parametrize("seed", [20260817, 5, 8])
def test_torch_fundamental_7point_candidate_set_equals_jax(seed):
    x1, x2, *_ = _scene(seed, n=7)
    ref = np.asarray(_j_fundamental_7point(jnp.asarray(x1), jnp.asarray(x2)))
    out = tmvg.fundamental_7point(_t(x1), _t(x2))
    assert tuple(out.shape) == (3, 3, 3)
    _match_sets(ref, out.numpy())
    # every candidate is rank 2, and in the JAX package's pencil
    assert float(torch.linalg.det(out).abs().max()) < 1e-12
    Fj = np.asarray(jmvg.fundamental_7point(jnp.asarray(x1), jnp.asarray(x2)))
    basis = np.linalg.qr(Fj.reshape(3, 9).T)[0][:, :2]
    flat = out.numpy().reshape(3, 9)
    assert np.abs(flat - flat @ basis @ basis.T).max() < 1e-12
    best = min(float(tmvg.sampson_distance_sq(out[i], _t(x1), _t(x2)).max())
               for i in range(3))
    assert best < 1e-10
    # batched: [2, 7, 2] gives [2, 3, 3, 3]
    outb = tmvg.fundamental_7point(_t(np.stack([x1, x1])),
                                   _t(np.stack([x2, x2])))
    _match_sets(ref, outb[1].numpy())


@pytest.mark.parametrize("seed", [20260817, 1, 2])
def test_torch_five_point_candidate_set_equals_jax(seed):
    x1, x2, R, t, _ = _scene(seed, n=5)
    Ej, vj = jfp.five_point_essential(jnp.asarray(x1), jnp.asarray(x2))
    Et, vt = tfp.five_point_essential(_t(x1), _t(x2))
    ref = np.asarray(Ej)[np.asarray(vj)]
    out = Et.numpy()[vt.numpy()]
    _match_sets(ref, out)
    E_gt = np.asarray(jso3.skew(jnp.asarray(t))) @ R
    E_gt /= np.linalg.norm(E_gt)
    assert min(_upto_sign(E_gt, e) for e in out) < 1e-6
    X1 = np.concatenate([x1, np.ones((5, 1))], 1)
    X2 = np.concatenate([x2, np.ones((5, 1))], 1)
    for E in out:
        assert np.abs(np.einsum("ni,ij,nj->n", X2, E, X1)).max() < 1e-6
        EEt = E @ E.T
        assert np.abs(2 * EEt @ E - np.trace(EEt) * E).max() < 1e-5


def test_torch_five_point_best_equals_jax():
    x1, x2, R, t, _ = _scene(20260817, n=30)
    m = np.ones(30, bool)
    Ej = np.asarray(jfp.five_point_best(*(jnp.asarray(a) for a in (
        x1[:5], x2[:5], x1, x2, m))))
    Et = tfp.five_point_best(_t(x1[:5]), _t(x2[:5]), _t(x1), _t(x2), _t(m))
    assert _upto_sign(Et.numpy(), Ej) < TOL
    R_t, t_t = tmvg.decompose_essential_best(Et, _t(x1), _t(x2), _t(m))
    np.testing.assert_allclose(R_t.numpy(), R, atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), t, atol=1e-5)


def _outlier_scene(seed, n, n_out, lo, hi):
    rng = np.random.default_rng(seed)
    x1, x2, *_ = (np.asarray(a) for a in two_view_scene(rng, n=n))
    x2b = x2.copy()
    out = rng.choice(n, size=n_out, replace=False)
    x2b[out] += rng.uniform(lo, hi, size=(n_out, 2))
    return x1, x2b, out


def test_torch_ransac_fundamental_equals_jax_given_samples():
    """test_ransac_fundamental_with_outliers: 8-point hypotheses."""
    x1, x2, out_idx = _outlier_scene(20260817, 60, 18, 0.1, 0.5)
    key = jax.random.PRNGKey(0)
    iters = max(jransac.ransac_iterations_count(0.999, 0.3, 8), 64)
    thr = (2.0 / 500.0) ** 2
    J1, J2 = jnp.asarray(x1), jnp.asarray(x2)
    ref = jransac.ransac(
        key, 60, 8, lambda i: jmvg.fundamental_8point(J1[i], J2[i],
                                                     jnp.ones(8, bool)),
        lambda F: jmvg.sampson_distance_sq(F, J1, J2), threshold=thr,
        iterations=iters)
    T1, T2 = _t(x1), _t(x2)
    fit = lambda i: tmvg.fundamental_8point(T1[i], T2[i],
                                            torch.ones(i.shape, dtype=bool))
    resid = lambda F: tmvg.sampson_distance_sq(F, T1, T2)
    out = transac.ransac(60, 8, fit, resid, thr,
                         samples=_jax_samples(key, 60, 8, iters))
    assert int(out.best_iter) == int(ref.best_iter)
    assert int(out.inlier_count) == int(ref.inlier_count)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert _upto_sign(out.model.numpy(), np.asarray(ref.model)) < TOL
    own = transac.ransac(60, 8, fit, resid, thr, iters,
                         generator=torch.Generator().manual_seed(0)).inliers
    assert not own.numpy()[out_idx].any() and int(own.sum()) >= 38


def test_torch_ransac_five_point_equals_jax_given_samples():
    """test_five_point_in_ransac: 5-point hypotheses, each its best
    candidate over the support set."""
    x1, x2, out_idx = _outlier_scene(20260817, 50, 15, 0.1, 0.4)
    key = jax.random.PRNGKey(0)
    thr = (2.0 / 500.0) ** 2
    J1, J2, Jm = jnp.asarray(x1), jnp.asarray(x2), jnp.ones(50, bool)
    ref = jransac.ransac(
        key, 50, 5, lambda i: jfp.five_point_best(J1[i], J2[i], J1, J2, Jm),
        lambda E: jmvg.sampson_distance_sq(E, J1, J2), threshold=thr,
        iterations=48)
    T1, T2, Tm = _t(x1), _t(x2), torch.ones(50, dtype=bool)
    out = transac.ransac(
        50, 5, lambda i: tfp.five_point_best(T1[i], T2[i], T1, T2, Tm),
        lambda E: tmvg.sampson_distance_sq(E, T1, T2), thr,
        samples=_jax_samples(key, 50, 5, 48))
    assert int(out.best_iter) == int(ref.best_iter)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert _upto_sign(out.model.numpy(), np.asarray(ref.model)) < TOL
    assert not out.inliers.numpy()[out_idx].any()
    assert int(out.inliers.sum()) >= 33


def test_torch_ransac_seven_point_candidates_axis():
    """7-point hypotheses with their three candidates (``candidates_axis``)
    against JAX's ``ransac`` of the corrected 7-point on the same samples,
    and a data mask."""
    x1, x2, out_idx = _outlier_scene(7, 60, 12, 0.1, 0.5)
    key = jax.random.PRNGKey(4)
    thr = (2.0 / 500.0) ** 2
    mask = np.ones(60, bool)
    mask[:3] = False
    J1, J2 = jnp.asarray(x1), jnp.asarray(x2)
    ref = jransac.ransac(
        key, 60, 7, lambda i: _j_fundamental_7point(J1[i], J2[i]),
        lambda F: jmvg.sampson_distance_sq(F, J1, J2), threshold=thr,
        iterations=64, data_mask=jnp.asarray(mask), candidates_axis=True)
    T1, T2 = _t(x1), _t(x2)
    out = transac.ransac(
        60, 7, lambda i: tmvg.fundamental_7point(T1[i], T2[i]),
        lambda F: tmvg.sampson_distance_sq(F, T1, T2), thr,
        samples=_jax_samples(key, 60, 7, 64), data_mask=_t(mask),
        candidates_axis=True)
    assert int(out.best_iter) == int(ref.best_iter)
    assert int(out.inlier_count) == int(ref.inlier_count)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert not out.inliers.numpy()[out_idx].any()


@pytest.mark.parametrize("noise", [2e-3, 0.0])
def test_torch_optimal_correction_equals_jax(noise):
    rng = np.random.default_rng(20260817)
    x1, x2, R, t, _ = (np.asarray(a) for a in two_view_scene(rng, n=20))
    E = np.asarray(jso3.skew(jnp.asarray(t))) @ R
    x1n = x1 + rng.normal(scale=noise, size=x1.shape)
    x2n = x2 + rng.normal(scale=noise, size=x2.shape)
    ref = jot.correct_correspondences_batch(jnp.asarray(E), jnp.asarray(x1n),
                                            jnp.asarray(x2n))
    out = tot.correct_correspondences_batch(_t(E), _t(x1n), _t(x2n))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=TOL)
    h1 = np.concatenate([out[0].numpy(), np.ones((20, 1))], 1)
    h2 = np.concatenate([out[1].numpy(), np.ones((20, 1))], 1)
    assert np.abs(np.einsum("ni,ij,nj->n", h2, E, h1)).max() < 1e-10
    one = tot.correct_correspondence(_t(E), _t(x1n[0]), _t(x2n[0]))
    np.testing.assert_allclose(one[0].numpy(), out[0][0].numpy(), rtol=0,
                               atol=1e-15)


def _k_close(out, ref, tol=1e-8):
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_torch_zhang_calibration_equals_jax():
    rng = np.random.default_rng(20260817)
    Hs = np.asarray(plane_homographies(rng, 6))
    mask = np.ones(6, bool)
    mask[2] = False
    for m in (None, mask):
        ref = np.asarray(jcal.calibrate_from_homographies(
            jnp.asarray(Hs), None if m is None else jnp.asarray(m)))
        out = tcal.calibrate_from_homographies(
            _t(Hs), None if m is None else _t(m)).numpy()
        _k_close(out, ref)
    np.testing.assert_allclose(out, K_GT, rtol=1e-6, atol=1e-3)
    # a batch of two problems, one batched Cholesky
    outb = tcal.calibrate_from_homographies(_t(np.stack([Hs, Hs[::-1]])))
    _k_close(outb[1].numpy(), ref)


def test_torch_rotating_camera_calibration_equals_jax():
    rng = np.random.default_rng(20260817)
    Kinv = np.linalg.inv(K_GT)
    Hs = np.stack([K_GT @ np.asarray(jso3.exp(jnp.asarray(
        rng.normal(scale=0.4, size=3)))) @ Kinv for _ in range(5)])
    Hs[1] *= -2.5                    # scale and sign are free
    ref = np.asarray(jcal.calibrate_from_rotation_homographies(jnp.asarray(Hs)))
    out = tcal.calibrate_from_rotation_homographies(_t(Hs)).numpy()
    _k_close(out, ref)
    np.testing.assert_allclose(out, K_GT, rtol=1e-5, atol=1e-2)
