"""MonoSlam filter math of the PyTorch port against the JAX package, in
float64: measurement Jacobians (also against torch.func.jacfwd), predict,
landmark initialization, the two health mechanisms, the blocked H products
and the fused frame steps (with deletion and the local depth prior) to
1e-10, plus the bitwise P == P^T invariant of the fused steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.models.monoslam import fused_step as jfs
from surikatoko_tpu.models.monoslam import health as jhealth
from surikatoko_tpu.models.monoslam import init_state as j_init_state
from surikatoko_tpu.models.monoslam import landmarks as jlm
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.models.monoslam import measure as jmeasure
from surikatoko_tpu.models.monoslam import predict as jpredict
from surikatoko_tpu.models.monoslam import update as jupdate
from surikatoko_tpu.world.device_runner import (
    _project_gt, build_oscillating_scenario, init_with_gt_landmarks)
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.models.monoslam import fused_step as tfs
from surikatoko_tpu_torch.models.monoslam import health as thealth
from surikatoko_tpu_torch.models.monoslam import landmarks as tlm
from surikatoko_tpu_torch.models.monoslam import measure as tmeasure
from surikatoko_tpu_torch.models.monoslam import predict as tpredict
from surikatoko_tpu_torch.models.monoslam import update as tupdate

torch.set_num_threads(2)
TOL = dict(rtol=1e-10, atol=1e-12)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


def _setup(capacity=12, n_free=4, repres=2, distorted=False, warm_frames=2,
           dtype=jnp.float64):
    """JAX state with evolved covariance and ``n_free`` free slots (the
    tests/test_recruit_fused.py::_setup recipe), and the frame's GT obs."""
    sc = build_oscillating_scenario(capacity=capacity, dtype=dtype)
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                               (0.01, 0.01), dtype=dtype)
    dist = (jcam.MikhailDistortion(jnp.asarray(0.2, dtype),
                                   jnp.asarray(0.02, dtype))
            if distorted else None)
    params = j_make_params(cam, dist, dt=1.0,
                           process_noise_lin_veloc_std=0.075,
                           process_noise_ang_veloc_std=0.01,
                           sal_pnt_init_inv_dist=0.5,
                           sal_pnt_init_inv_dist_std=0.4,
                           covar_diag_inflation=1e-6,
                           sal_pnt_repres=repres, dtype=dtype)
    state = init_with_gt_landmarks(params, sc, j_init_state(capacity, dtype=dtype),
                                   jax.random.PRNGKey(0))
    state = jlm.remove_landmarks(state, jnp.arange(capacity) >= capacity - n_free)
    for f in range(1, 1 + warm_frames):
        obs, vis = _project_gt(params, sc, jnp.asarray(f),
                               jax.random.PRNGKey(10 + f))
        xn, Pn, _, _ = jfs.fused_update_health_predict(
            params, state.x, state.P, obs, vis & state.lm_active)
        state = state._replace(x=xn, P=Pn)
    obs, vis = _project_gt(params, sc, jnp.asarray(1 + warm_frames),
                           jax.random.PRNGKey(1))
    return params, state, obs, vis & state.lm_active


@pytest.mark.parametrize("repres,distorted", [(2, False), (2, True), (1, False)])
def test_torch_measurement_jacobians(repres, distorted):
    # no free slots: a freed XYZ slot sits at the origin, where the camera
    # started, and its NaN rows poison the masked reference update
    params, state, _, _ = _setup(repres=repres, distorted=distorted,
                                 n_free=4 if repres == 2 else 0)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    x = _t(state.x)
    h_t, Hc_t, Hl_t = tmeasure.measurement_jacobians(tp, x)
    h_j, Hc_j, Hl_j = jmeasure.measurement_jacobians(params, state.x)
    _close(h_t, h_j)
    _close(Hc_t, Hc_j)
    _close(Hl_t, Hl_j)
    # the autodiff oracle: jacfwd of the forward model per slot
    cam13, lms = x[:13], x[13:].reshape(-1, 6)
    f = lambda c, lm: tmeasure.project_landmark(tp, c, lm)
    Hc_ad, Hl_ad = vmap(jacfwd(f, argnums=(0, 1)), in_dims=(None, 0))(cam13, lms)
    assert bool(torch.isfinite(Hc_t).all() and torch.isfinite(Hl_t).all())
    _close(Hc_t, Hc_ad, rtol=1e-9, atol=1e-9)
    _close(Hl_t, Hl_ad, rtol=1e-9, atol=1e-9)


def test_torch_predict(rng):
    params, state, _, _ = _setup()
    tp = interop.params_from_numpy(_np(params), device="cpu")
    cam = state.x[:13].at[10:13].set(jnp.asarray(0.05 * rng.normal(size=3)))
    cam_t = _t(cam)
    _close(tpredict.predict_camera(tp, cam_t), jpredict.predict_camera(params, cam))
    F_t, G_t = tpredict.camera_transition_jacobians(tp, cam_t)
    F_j, G_j = jpredict.camera_transition_jacobians(params, cam)
    _close(F_t, F_j)
    _close(G_t, G_j)
    F_ad = jacfwd(lambda c: tpredict.predict_camera(tp, c))(cam_t)
    G_ad = jacfwd(lambda n: tpredict.predict_camera(tp, cam_t, n))(
        torch.zeros(6, dtype=torch.float64))
    _close(F_t, F_ad, rtol=1e-9, atol=1e-12)
    _close(G_t, G_ad, rtol=1e-9, atol=1e-12)
    st = state._replace(x=state.x.at[:13].set(cam))
    pj = jpredict.predict(params, st)
    pt = tpredict.predict(tp, interop.state_from_numpy(_np(st), device="cpu"))
    _close(pt.x, pj.x)
    _close(pt.P, pj.P)


@pytest.mark.parametrize("repres", [2, 1])
def test_torch_add_landmarks(rng, repres):
    params, state, _, _ = _setup(n_free=3, repres=repres)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    pix = rng.uniform([20.0, 20.0], [300.0, 220.0], size=(5, 2))
    ok = np.array([True, False, True, True, True])   # 4 valid, 3 free slots
    rho = np.array([np.nan, 0.7, 1.3, np.nan, 0.4])
    sj, slots_j = jlm.add_landmarks(params, state, jnp.asarray(pix),
                                    jnp.asarray(ok), jnp.asarray(rho))
    st, slots_t = tlm.add_landmarks(tp, interop.state_from_numpy(_np(state),
                                                                 device="cpu"),
                                    _t(pix), _t(ok), _t(rho))
    np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))
    np.testing.assert_array_equal(st.lm_active.numpy(), np.asarray(sj.lm_active))
    np.testing.assert_array_equal(st.lm_generation.numpy(),
                                  np.asarray(sj.lm_generation))
    _close(st.x, sj.x)
    _close(st.P, sj.P)


def test_torch_health(rng):
    """Negative inverse-depth substitution and the nonnegative-variance
    clamp, on a state with some negative rho and negative variances."""
    K = 6
    D = 13 + 6 * K
    x = rng.normal(size=D)
    P = rng.normal(size=(D, D))
    P = P + P.T
    sub = np.asarray(1e-4)
    x_t, n_t = thealth.substitute_negative_inv_rho(_t(x), _t(sub), K)
    x_j, n_j = jhealth.substitute_negative_inv_rho(jnp.asarray(x),
                                                   jnp.asarray(sub), K)
    _close(x_t, x_j)
    assert int(n_t) == int(n_j) > 0
    P_t = thealth.ensure_nonneg_variance(_t(P))
    _close(P_t, jhealth.ensure_nonneg_variance(jnp.asarray(P)))
    assert bool((torch.diagonal(P_t) >= 0).all())


@pytest.mark.parametrize("K", [16, 256])
def test_torch_h_products(rng, K):
    """Dense path (K=16) and the grouped block-diagonal path (K=256, g=64)."""
    D = 13 + 6 * K
    Hc, Hl = rng.normal(size=(K, 2, 13)), rng.normal(size=(K, 2, 6))
    L = rng.normal(size=(D, D)) / np.sqrt(D)
    P = L @ L.T
    A_j = jupdate.hp_auto(jnp.asarray(Hc), jnp.asarray(Hl), jnp.asarray(P))
    A_t = tupdate.hp_auto(_t(Hc), _t(Hl), _t(P))
    _close(A_t, A_j)
    _close(tupdate.aht_auto(A_t, _t(Hc), _t(Hl)),
           jupdate.aht_auto(A_j, jnp.asarray(Hc), jnp.asarray(Hl)))
    assert tupdate._h_group(K) == jupdate._h_group(K) == (64 if K == 256 else 0)


@pytest.mark.parametrize("precomputed", [False, True])
def test_torch_fused_update_health_predict(precomputed):
    params, state, obs, m = _setup(n_free=2)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    drop = jnp.zeros(state.capacity, bool).at[3].set(True)
    m = m & ~drop
    kw_j = dict(deactivate_mask=drop)
    kw_t = dict(deactivate_mask=_t(drop))
    if precomputed:
        h, Hc, Hl = jmeasure.measurement_jacobians(params, state.x)
        A = jupdate.hp_auto(Hc, Hl, state.P)
        kw_j["precomputed"] = (h, A, jupdate.aht_auto(A, Hc, Hl))
        kw_t["precomputed"] = tuple(_t(a) for a in kw_j["precomputed"])
    out_j = jfs.fused_update_health_predict(params, state.x, state.P, obs, m,
                                            **kw_j)
    out_t = tfs.fused_update_health_predict(tp, _t(state.x), _t(state.P),
                                            _t(obs), _t(m), **kw_t)
    for a, b in zip(out_t[:4], out_j):
        _close(a, b)
    assert int(out_t[4]) == 0
    assert torch.equal(out_t[1], out_t[1].T)


def _recruit_inputs(params, state, rng, drop_slots=(2, 5)):
    cap = state.capacity
    drop = jnp.zeros(cap, bool).at[jnp.asarray(drop_slots)].set(True)
    active_after = state.lm_active & ~drop
    new_pix = jnp.asarray(rng.uniform([20.0, 20.0], [300.0, 220.0], size=(4, 2)))
    new_valid = jnp.asarray([True, True, False, True])
    slot_pix = jmeasure.measurement_jacobians(params, state.x)[0]
    rho0 = jfs.local_tracked_inv_depth(params, state.x, active_after, cap,
                                       new_pix, slot_pix, k_nearest=4)
    return drop, active_after, new_pix, new_valid, slot_pix, rho0


def test_torch_fused_recruit_with_deletion_and_local_depth(rng):
    params, state, obs, m = _setup(n_free=1)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    drop, active_after, new_pix, new_valid, slot_pix, rho0_j = _recruit_inputs(
        params, state, rng)
    m = m & ~drop
    rho0_t = tfs.local_tracked_inv_depth(tp, _t(state.x), _t(active_after),
                                         state.capacity, _t(new_pix),
                                         _t(slot_pix), k_nearest=4)
    _close(rho0_t, rho0_j)
    out_j = jfs.fused_update_health_recruit_predict(
        params, state.x, state.P, obs, m, new_pix, new_valid, ~active_after,
        deactivate_mask=drop, rho0=rho0_j)
    out_t = tfs.fused_update_health_recruit_predict(
        tp, _t(state.x), _t(state.P), _t(obs), _t(m), _t(new_pix),
        _t(new_valid), _t(~active_after), deactivate_mask=_t(drop),
        rho0=rho0_t)
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    assert set(out_t[4].tolist()) == {2, 5, state.capacity - 1, -1}
    for a, b in zip(out_t[:4], out_j[:4]):
        _close(a, b)
    assert int(out_t[5]) == 0
    assert torch.equal(out_t[1], out_t[1].T)


def test_torch_median_tracked_inv_depth(rng):
    """The global depth prior of recruit_depth="median", with deleted slots
    and with no usable slot at all (the configured prior)."""
    params, state, _, _ = _setup(n_free=1)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    active_after = _recruit_inputs(params, state, rng)[1]
    for active in (active_after, jnp.zeros_like(active_after)):
        _close(tfs.median_tracked_inv_depth(tp, _t(state.x), _t(active),
                                            state.capacity),
               jfs.median_tracked_inv_depth(params, state.x, active,
                                            state.capacity))


def test_torch_fused_recruit_none_valid_and_overflow(rng):
    """No valid candidate leaves the base fused step untouched; more valid
    candidates than free slots fill only the free ones, in order."""
    params, state, obs, m = _setup(n_free=2)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    free = ~state.lm_active
    pix = jnp.asarray(rng.uniform([20.0, 20.0], [300.0, 220.0], size=(5, 2)))
    args_t = (tp, _t(state.x), _t(state.P), _t(obs), _t(m), _t(pix))
    none = tfs.fused_update_health_recruit_predict(
        *args_t, torch.zeros(5, dtype=torch.bool), _t(free))
    base = tfs.fused_update_health_predict(*args_t[:5])
    assert (none[4] < 0).all()
    assert torch.equal(none[0], base[0]) and torch.equal(none[1], base[1])
    all_valid = jnp.ones(5, bool)
    out_j = jfs.fused_update_health_recruit_predict(
        params, state.x, state.P, obs, m, pix, all_valid, free)
    out_t = tfs.fused_update_health_recruit_predict(
        *args_t, _t(all_valid), _t(free))
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    assert int((out_t[4] >= 0).sum()) == 2
    for a, b in zip(out_t[:4], out_j[:4]):
        _close(a, b)


def test_torch_fused_recruit_symmetry_exact_f32(rng):
    """P+ with recruits scattered in stays exactly symmetric in float32."""
    params, state, obs, m = _setup(dtype=jnp.float32)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    pix = rng.uniform([20.0, 20.0], [300.0, 220.0], size=(3, 2)).astype(np.float32)
    out = tfs.fused_update_health_recruit_predict(
        tp, _t(state.x), _t(state.P), _t(obs), _t(m), _t(pix),
        torch.tensor([True, True, False]), _t(~state.lm_active))
    assert out[1].dtype == torch.float32
    assert torch.equal(out[1], out[1].T)
    assert int((out[4] >= 0).sum()) == 2
