"""The port's filter-health layer, landmark lifecycle and slot conversions
against the JAX package, in float64 on the CPU: quaternion renorm with its
covariance, the landmark position covariances and the bad-ellipsoid mask,
reset to GT (both covariance strategies, both representations), remove,
the closed-form new-landmark Jacobians (against torch.func.jacfwd), and the
reference's own cases of tests/test_reset_to_gt.py and
tests/test_monoslam_xyz.py on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.geom import quat as jquat
from surikatoko_tpu.geom.se3 import SE3 as JSE3
from surikatoko_tpu.models.monoslam import health as jhealth
from surikatoko_tpu.models.monoslam import landmarks as jlm
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.models.monoslam import measure as jmeasure
from surikatoko_tpu.world.runner import run_scenario as j_run_scenario
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.geom import quat as tquat
from surikatoko_tpu_torch.geom.se3 import SE3 as TSE3
from surikatoko_tpu_torch.models.monoslam import health as thealth
from surikatoko_tpu_torch.models.monoslam import init_state as t_init_state
from surikatoko_tpu_torch.models.monoslam import landmarks as tlm
from surikatoko_tpu_torch.models.monoslam import measure as tmeasure
from surikatoko_tpu_torch.models.monoslam.state import CAM_STATE_COMPS as N
from surikatoko_tpu_torch.world import runner as trunner

from tests.test_torch_filter import make_pair

torch.set_num_threads(2)
TOL = dict(rtol=1e-10, atol=1e-12)


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


def _params(repres=2, distorted=False):
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01))
    dist = (jcam.MikhailDistortion(jnp.float64(0.2), jnp.float64(0.02))
            if distorted else None)
    pj = j_make_params(cam, dist, dt=1.0, process_noise_lin_veloc_std=0.075,
                       process_noise_ang_veloc_std=0.01, sal_pnt_repres=repres,
                       sal_pnt_init_inv_dist_std=0.4)
    return pj, interop.params_from_numpy(_np(pj), device="cpu")


def _random_state(rng, K, repres=2):
    """x with a non-unit quaternion, some negative or zero rho (spherical),
    and a symmetric PSD P with a few indefinite landmark blocks."""
    D = N + 6 * K
    x = rng.normal(size=D)
    x[3:7] = [0.9, 0.1, -0.3, 0.2]
    lms = x[N:].reshape(K, 6)
    lms[:, 5] = rng.uniform(0.2, 2.0, size=K)
    if repres == 2:
        lms[1, 5], lms[2, 5] = -0.3, 0.0
    else:
        lms[:, 3:] = 0.0
    A = rng.normal(size=(D, D))
    P = A @ A.T / D
    off = N + 6 * 3
    P[off:off + 6, off:off + 6] -= 5.0 * np.eye(6)          # indefinite slot 3
    return x, P


def test_torch_normalize_quat_and_covar(rng):
    x, P = _random_state(rng, 5)
    xt, Pt = thealth.normalize_quat_and_covar(_t(x), _t(P))
    xj, Pj = jhealth.normalize_quat_and_covar(jnp.asarray(x), jnp.asarray(P))
    _close(xt, xj)
    _close(Pt, Pj)
    assert torch.equal(Pt, Pt.T)
    _close(thealth.symmetrize(_t(x[:13, None] * x[None, :13])),
           jhealth.symmetrize(jnp.asarray(x[:13, None] * x[None, :13])))


@pytest.mark.parametrize("repres,substitute", [(2, True), (2, False), (1, True)])
def test_torch_landmark_covariances_and_bad_mask(rng, repres, substitute):
    K = 6
    x, P = _random_state(rng, K, repres)
    sub = np.asarray(1e-4)
    sj = jnp.asarray(sub) if substitute else None
    st = _t(sub) if substitute else None
    pos_t, cov_t = thealth.landmark_pos_covariances(_t(x), _t(P), K, st, repres)
    pos_j, cov_j = jhealth.landmark_pos_covariances(jnp.asarray(x), jnp.asarray(P),
                                                    K, sj, repres)
    fin = np.isfinite(np.asarray(cov_j))
    np.testing.assert_array_equal(np.isfinite(cov_t.numpy()), fin)
    _close(pos_t, pos_j, rtol=1e-10, atol=1e-10)
    _close(cov_t.numpy()[fin], np.asarray(cov_j)[fin], rtol=1e-9, atol=1e-9)
    if substitute:
        bad_t = thealth.bad_uncertainty_mask(_t(x), _t(P), K, st, repres)
        bad_j = jhealth.bad_uncertainty_mask(jnp.asarray(x), jnp.asarray(P), K,
                                             sj, repres)
        np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
        assert bool(bad_t[3]) and not bool(bad_t[0])


def test_torch_reset_camera_and_check_state(rng):
    K = 4
    x, P = _random_state(rng, K)
    st = interop.state_from_numpy(_np(jlm_state(x, P, K)), device="cpu")
    gt13 = rng.normal(size=13)
    got = thealth.reset_camera_to_gt(st, _t(gt13), 0.1, 0.02, 0.3, 0.04)
    want = jhealth.reset_camera_to_gt(jlm_state(x, P, K), jnp.asarray(gt13),
                                      0.1, 0.02, 0.3, 0.04)
    _close(got.x, want.x)
    _close(got.P, want.P)
    assert bool(thealth.check_state(st)) == bool(jhealth.check_state(jlm_state(x, P, K)))
    assert not bool(thealth.check_state(st))           # |q| != 1
    good = st._replace(x=torch.cat([st.x[:3], tquat.normalize(st.x[3:7]),
                                    st.x[7:]]),
                       P=torch.eye(P.shape[0], dtype=torch.float64))
    assert bool(thealth.check_state(good))


def jlm_state(x, P, K):
    """A JAX MonoSlamState with the given x, P and every slot active."""
    from surikatoko_tpu.models.monoslam import init_state
    s = init_state(K)
    return s._replace(x=jnp.asarray(x), P=jnp.asarray(P),
                      lm_active=jnp.ones(K, bool))


@pytest.mark.parametrize("impl", [1, 2])
@pytest.mark.parametrize("repres", [2, 1])
def test_torch_reset_state_to_gt_matches_jax(rng, impl, repres):
    K = 6
    pj, pt = _params(repres)
    x, P = _random_state(rng, K, repres)
    sj = jlm_state(x, P, K)
    st = interop.state_from_numpy(_np(sj), device="cpu")
    gt13 = np.r_[rng.normal(scale=0.2, size=3),
                 np.asarray(jnp.asarray([0.98, 0.05, -0.1, 0.1])
                            / np.linalg.norm([0.98, 0.05, -0.1, 0.1])),
                 rng.normal(scale=0.05, size=6)]
    pix = rng.uniform((40, 40), (280, 200), size=(K, 2))
    rho = rng.uniform(0.3, 0.9, size=K)
    mask = np.array([True, True, False, True, False, True])
    kw = dict(impl=impl, cam_pos_std=1e-3, cam_q_comp_std=1e-3, cam_vel_std=0.05,
              cam_ang_vel_std=0.01, sal_pnt_first_cam_pos_std=1e-3,
              sal_pnt_azimuth_std=2e-3, sal_pnt_elevation_std=3e-3,
              sal_pnt_inv_dist_std=0.1, sal_pnt_pos_std=(0.01, 0.02, 0.03))
    want = jhealth.reset_state_to_gt(pj, sj, jnp.asarray(gt13), jnp.asarray(pix),
                                     jnp.asarray(rho), jnp.asarray(mask), **kw)
    got = thealth.reset_state_to_gt(pt, st, _t(gt13), _t(pix), _t(rho),
                                    _t(mask), **kw)
    _close(got.x, want.x)
    _close(got.P, want.P)
    np.testing.assert_array_equal(got.lm_active.numpy(), mask)
    np.testing.assert_array_equal(got.lm_unobserved.numpy(),
                                  np.asarray(want.lm_unobserved))
    assert torch.equal(got.P, got.P.T)


def test_torch_remove_landmarks(rng):
    K = 6
    x, P = _random_state(rng, K)
    sj = jlm_state(x, P, K)._replace(lm_active=jnp.asarray(
        [True, True, False, True, True, True]))
    st = interop.state_from_numpy(_np(sj), device="cpu")
    remove = np.array([False, True, True, False, True, False])
    got = tlm.remove_landmarks(st, _t(remove))
    want = jlm.remove_landmarks(sj, jnp.asarray(remove))
    _close(got.x, want.x, rtol=0, atol=0)
    _close(got.P, want.P, rtol=0, atol=0)
    np.testing.assert_array_equal(got.lm_active.numpy(), np.asarray(want.lm_active))


@pytest.mark.parametrize("repres,distorted", [(2, False), (2, True), (1, False),
                                              (1, True)])
def test_torch_new_landmark_jacobians_closed_form(rng, repres, distorted):
    """The closed-form Jacobians against torch.func.jacfwd of
    new_landmark_state, candidate by candidate."""
    _, pt = _params(repres, distorted)
    cam = torch.as_tensor(np.r_[rng.normal(scale=0.3, size=3),
                                [0.95, 0.1, -0.2, 0.15]])
    pix = _t(rng.uniform((20, 20), (300, 220), size=(5, 2)))
    rho = _t(rng.uniform(0.2, 1.5, size=5))
    y, Jc, Jp, Jr = tlm.new_landmark_jacobians(pt, cam, pix, rho)
    g = lambda c, p, r: tlm.new_landmark_state(pt, c, p, r)
    for m in range(5):
        jc, jp, jr = jacfwd(g, argnums=(0, 1, 2))(cam, pix[m], rho[m])
        _close(y[m], g(cam, pix[m], rho[m]), rtol=1e-13, atol=1e-13)
        _close(Jc[m], jc, rtol=1e-9, atol=1e-11)
        _close(Jp[m], jp, rtol=1e-9, atol=1e-11)
        _close(Jr[m], jr, rtol=1e-9, atol=1e-11)


def test_torch_slot_conversions(rng):
    """measure's slot conversions against JAX, and
    test_monoslam_xyz.py::test_slot_conversion_roundtrip on the port."""
    for _ in range(5):
        first = rng.normal(size=3)
        pos = first + rng.normal(size=3) + np.array([0.0, 0.0, 3.0])
        xyz = np.r_[pos, np.zeros(3)]
        sph_t = tmeasure.xyz_to_spherical_slot(_t(xyz), _t(first))
        sph_j = jmeasure.xyz_to_spherical_slot(jnp.asarray(xyz), jnp.asarray(first))
        _close(sph_t, sph_j)
        _close(tmeasure.landmark_world_pos(sph_t), pos, rtol=0, atol=1e-12)
        _close(tmeasure.spherical_to_xyz_slot(sph_t)[:3], pos, rtol=0, atol=1e-12)
        _close(tmeasure.spherical_to_xyz_slot(sph_t),
               jmeasure.spherical_to_xyz_slot(sph_j))
    lm = np.r_[rng.normal(size=5), -0.2]
    _close(tmeasure.landmark_world_pos(_t(lm), _t(0.01)),
           jmeasure.landmark_world_pos(jnp.asarray(lm), jnp.asarray(0.01)))


def test_torch_xyz_projection_parity_and_init(rng):
    """test_monoslam_xyz.py's projection parity between representations,
    the new landmark on its ray, and sigma_rho spread along the ray."""
    _, p_xyz = _params(1)
    _, p_sph = _params(2)
    for _ in range(5):
        cam13 = _t(np.r_[rng.normal(scale=0.3, size=3), [1.0, 0, 0, 0], np.zeros(6)])
        pos = _t(rng.normal(size=3) + np.array([0, 0, 4.0]))
        xyz_slot = torch.cat([pos, torch.zeros(3, dtype=torch.float64)])
        sph_slot = tmeasure.xyz_to_spherical_slot(
            xyz_slot, _t(rng.normal(scale=0.2, size=3)))
        _close(tmeasure.project_landmark(p_xyz, cam13, xyz_slot),
               tmeasure.project_landmark(p_sph, cam13, sph_slot), rtol=0, atol=1e-9)
    cam_pq = _t([0.1, -0.2, 0.3, 1.0, 0, 0, 0])
    pix = _t([170.0, 110.0])
    slot = tlm.new_landmark_state(p_xyz, cam_pq, pix, _t(0.25))
    _close(slot[3:], np.zeros(3), rtol=0, atol=0)
    _close(torch.linalg.norm(slot[:3] - cam_pq[:3]), 4.0, rtol=1e-10, atol=0)
    _close(tmeasure.project_landmark(p_xyz, torch.cat([cam_pq, torch.zeros(6,
                                     dtype=torch.float64)]), slot), pix,
           rtol=0, atol=1e-8)
    D = 13 + 6 * 4
    x = torch.zeros(D, dtype=torch.float64)
    x[3] = 1.0
    _, auto, _ = tlm.new_landmark_covariance(
        p_xyz, x, torch.zeros((D, D), dtype=torch.float64), _t([160.0, 120.0]),
        _t(0.5), _t(0.1))
    _close(auto[2, 2], 0.1**2 * 16.0, rtol=1e-6, atol=0)
    _close(auto[3:, :], np.zeros((3, 6)), rtol=0, atol=1e-12)


def test_torch_reset_impl2_matches_add_landmarks_covariance(rng):
    """test_reset_to_gt.py's case on the port: impl 2 equals what
    add_landmarks gives on a fresh state when slots fill in order."""
    _, pt = _params()
    K = 6
    gt13 = _t(np.r_[[0.1, -0.2, 0.05], [1.0, 0, 0, 0], np.zeros(6)])
    pix = _t(rng.uniform((40, 40), (280, 200), size=(K, 2)))
    rho = _t(rng.uniform(0.3, 0.9, size=K))
    mask = torch.ones(K, dtype=torch.bool)
    st = t_init_state(K, device="cpu")
    reset = thealth.reset_state_to_gt(pt, st, gt13, pix, rho, mask, impl=2)
    added, _ = tlm.add_landmarks(
        pt, st._replace(x=torch.cat([gt13, st.x[N:]])), pix, mask, rho)
    _close(reset.x, added.x, rtol=0, atol=1e-12)
    _close(reset.P, added.P, rtol=0, atol=1e-12)


def test_torch_reset_impl1_diagonal_blocks():
    """test_reset_to_gt.py's impl 1 case on the port."""
    _, pt = _params()
    K = 4
    st = t_init_state(K, device="cpu")
    gt13 = _t(np.r_[np.zeros(3), [1.0, 0, 0, 0], np.zeros(6)])
    mask = _t([True, False, True, True])
    st2 = thealth.reset_state_to_gt(
        pt, st, gt13, torch.full((K, 2), 120.0, dtype=torch.float64),
        torch.full((K,), 0.5, dtype=torch.float64), mask, impl=1,
        cam_pos_std=0.01, sal_pnt_first_cam_pos_std=0.02,
        sal_pnt_azimuth_std=0.03, sal_pnt_elevation_std=0.04,
        sal_pnt_inv_dist_std=0.05)
    P = st2.P.numpy()
    np.testing.assert_array_equal(P, np.diag(np.diag(P)))
    _close(np.diag(P)[N:N + 6],
           [0.02**2, 0.02**2, 0.02**2, 0.03**2, 0.04**2, 0.05**2])
    assert np.all(np.diag(P)[N + 6:N + 12] == 0)
    assert not bool(st2.lm_active[1])


@pytest.mark.parametrize("impl", [1, 2])
def test_torch_reset_to_gt_recovers_tracking(impl):
    """test_reset_to_gt_recovers_tracking on both packages: 10 frames, 12
    frames coasting blind, reset to GT, 12 frames; the port's drift, reset
    and recovery as the reference asserts them, and its camera errors after
    the reset within 1e-9 of JAX's."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(1, matcher_kw=dict(
        detection_noise_std=0.5))
    errs = {}
    for side, tr, m, gt, run in (("j", jt, jm, jg, j_run_scenario),
                                 ("t", tt, tm, tg, trunner.run_scenario)):
        hl, sep = (jhealth, jnp.asarray) if side == "j" else (thealth, _t)
        se3 = JSE3 if side == "j" else TSE3
        state = run(tr, m, gt, n_frames=10).state
        m.suppress_observations = True
        for f in range(10, 22):
            obs, mask = m.match_salient_points(state, f)
            npix, nm, rho, _ = m.recruit_new_salient_points(state, f, mask)
            state, _ = tr.process_frame(state, obs, mask, npix, nm, rho)
        m.suppress_observations = False
        wfc = se3(gt.R[22], gt.t[22]).inv()
        wfc_t = np.asarray(wfc.t)
        assert float(np.linalg.norm(np.asarray(state.x[:3]) - wfc_t)) > 0.01
        q = np.asarray(jquat.from_rotmat(jnp.asarray(np.asarray(wfc.R))))
        gt13 = np.r_[wfc_t, q, np.zeros(6)]
        gt_pix, gt_rho, slot_mask = m.gt_state_for_reset(state, 22)
        state = hl.reset_state_to_gt(
            tr.params, state, sep(gt13), sep(gt_pix), sep(gt_rho),
            sep(slot_mask), impl=impl, cam_pos_std=1e-4, cam_q_comp_std=1e-4,
            cam_vel_std=0.05, cam_ang_vel_std=0.01,
            sal_pnt_first_cam_pos_std=1e-4, sal_pnt_azimuth_std=1e-3,
            sal_pnt_elevation_std=1e-3, sal_pnt_inv_dist_std=0.1)
        assert float(np.linalg.norm(np.asarray(state.x[:3]) - wfc_t)) < 1e-9
        P = np.asarray(state.P)
        assert np.isfinite(P).all() and (np.diag(P) >= 0).all()
        np.testing.assert_allclose(P, P.T, atol=1e-12)
        e = []
        for f in range(22, 34):
            obs, mask = m.match_salient_points(state, f)
            npix, nm, rho, fids = m.recruit_new_salient_points(state, f, mask)
            state, stats = tr.process_frame(state, obs, mask, npix, nm, rho)
            m.on_landmarks_added(stats.new_slots if side == "t"
                                 else np.asarray(stats.new_slots), fids, state)
            m.sync_removed(state)
            wfc_f = se3(gt.R[f], gt.t[f]).inv()
            e.append(float(np.linalg.norm(np.asarray(stats.cam_state[:3])
                                          - np.asarray(wfc_f.t))))
        errs[side] = e
    assert errs["t"][-1] < 0.05, errs["t"]
    np.testing.assert_allclose(errs["t"], errs["j"], rtol=0, atol=1e-9)


def test_torch_bad_mask_keeps_an_elongated_positive_definite_ellipsoid(rng):
    """A landmark position covariance L^2 m m^T + s^2 I (L = 1e6, s = 10: a
    substituted rho's ellipsoid, condition ~1e10) is positive definite. Its
    leading 3x3 minor, as JAX forms it, cancels to rounding (below 1e3 eps
    of the diagonals' product, so its sign is rounding's); the port's
    Cholesky pivots keep it, and mark a truly indefinite block bad."""
    K = 3
    m = rng.normal(size=3)
    m /= np.linalg.norm(m)
    C = 1e12 * np.outer(m, m) + 100.0 * np.eye(3)
    assert np.linalg.eigvalsh(C).min() > 0
    D = N + 6 * K
    x = np.zeros(D)
    x[3] = 1.0
    x[N:] = np.tile([0.1, 0.2, 3.0, 0.0, 0.0, 0.0], K)
    P = np.zeros((D, D))
    for k in range(K):
        P[N + 6 * k:N + 6 * k + 3, N + 6 * k:N + 6 * k + 3] = 0.01 * np.eye(3)
    P[N:N + 3, N:N + 3] = C
    off = N + 12
    P[off:off + 3, off:off + 3] = np.diag([1.0, -1e-3, 1.0])    # indefinite
    bad = thealth.bad_uncertainty_mask(_t(x), _t(P), K, _t(1e-4), 1)
    np.testing.assert_array_equal(bad.numpy(), [False, False, True])
    a, b, c, d, e, f = C[0, 0], C[0, 1], C[0, 2], C[1, 1], C[1, 2], C[2, 2]
    det3 = a * (d * f - e * e) - b * (b * f - e * c) + c * (b * e - d * c)
    assert abs(det3) < 1e3 * np.finfo(float).eps * a * d * f
