"""The EKF update strategies of the PyTorch port against the JAX package in
float64 on the CPU, on tests/test_monoslam_update.py's inputs (K=6,
distorted camera): stacked, sequential per-observation and per-component,
and 1-point RANSAC updates, project_all and normalize_and_predict, at
1e-12. Then the repair of the masked-Jacobian NaN (ROADMAP C.2): on an XYZ
state whose freed slots sit at the camera's position JAX's updates return
NaN, and the port's stay finite; on spherical states the port still matches
JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.models.monoslam import fused_step as jfs
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
from surikatoko_tpu_torch.models.monoslam import measure as tmeasure
from surikatoko_tpu_torch.models.monoslam import predict as tpredict
from surikatoko_tpu_torch.models.monoslam import update as tupdate

torch.set_num_threads(2)
K = 6
N = 13
D = N + 6 * K
TOL = dict(rtol=0, atol=1e-12)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


@pytest.fixture
def params():
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01))
    dist = jcam.MikhailDistortion(jnp.float64(0.06), jnp.float64(0.01))
    return j_make_params(cam, dist, dt=1.0)


@pytest.fixture
def state_xP(rng):
    """tests/test_monoslam_update.py's state."""
    x = np.zeros(D)
    x[0:3] = rng.normal(scale=0.1, size=3)
    q = rng.normal(size=4)
    x[3:7] = q / np.linalg.norm(q)
    x[7:13] = rng.normal(scale=0.05, size=6)
    for k in range(K):
        off = N + 6 * k
        x[off:off + 3] = rng.normal(scale=0.1, size=3)
        x[off + 3] = rng.normal(scale=0.3)
        x[off + 4] = rng.normal(scale=0.2)
        x[off + 5] = abs(rng.normal(scale=0.3)) + 0.05
    A = rng.normal(size=(D, D)) * 0.01
    return jnp.asarray(x), jnp.asarray(A @ A.T)


def _obs(params, x, rng, scale):
    return jmeasure.project_all(params, x) + jnp.asarray(
        rng.normal(scale=scale, size=(K, 2)))


MASKS = {"some": [True, True, False, True, False, True],
         "all": [True] * K, "none": [False] * K}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_torch_stacked_update(params, state_xP, rng, mask):
    x, P = state_xP
    obs_mask = jnp.asarray(MASKS[mask])
    obs = _obs(params, x, rng, 1.0)
    want = jupdate.stacked_update(params, x, P, obs, obs_mask)
    got = tupdate.stacked_update(interop.params_from_numpy(_np(params), device="cpu"),
                                 _t(x), _t(P), _t(obs), _t(obs_mask))
    for a, b in zip(got[:3], want):
        _close(a, b)
    assert int(got[3]) == 0
    assert torch.equal(got[1], got[1].T)
    if mask == "none":      # a fully masked update is a no-op
        _close(got[0], x)
        _close(got[1], P)


@pytest.mark.parametrize("name", ["one_obs_update", "one_component_update"])
def test_torch_sequential_updates(params, state_xP, rng, name):
    x, P = state_xP
    obs_mask = jnp.asarray(MASKS["some"])
    obs = _obs(params, x, rng, 0.5)
    want = getattr(jupdate, name)(params, x, P, obs, obs_mask)
    got = getattr(tupdate, name)(interop.params_from_numpy(_np(params), device="cpu"),
                                 _t(x), _t(P), _t(obs), _t(obs_mask))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("outlier", [False, True])
def test_torch_one_point_ransac_update(params, state_xP, rng, outlier):
    """With a gross mismatch (test_ransac_rejects_gross_outlier's case) and
    without: the same low and high inlier counts, x and P at 1e-12."""
    x, P = state_xP
    obs_mask = jnp.ones(K, bool)
    obs = _obs(params, x, rng, 0.3)
    if outlier:
        obs = obs.at[2].add(jnp.asarray([150.0, -120.0]))
    want = jupdate.one_point_ransac_update(params, x, P, obs, obs_mask)
    got = tupdate.one_point_ransac_update(
        interop.params_from_numpy(_np(params), device="cpu"), _t(x), _t(P), _t(obs),
        _t(obs_mask))
    assert int(got[3]) == int(want[3]) >= 2
    assert int(got[4]) == int(want[4])
    if outlier:
        assert int(got[3]) + int(got[4]) <= K - 1
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)
    assert int(got[5]) == 0
    assert torch.equal(got[1], got[1].T)


def test_torch_project_all(params, state_xP, rng):
    """One state, and a batch of states in place of JAX's vmap."""
    x, _ = state_xP
    tp = interop.params_from_numpy(_np(params), device="cpu")
    _close(tmeasure.project_all(tp, _t(x)), jmeasure.project_all(params, x))
    xs = x[None, :] + jnp.asarray(rng.normal(scale=0.01, size=(4, D)))
    _close(tmeasure.project_all(tp, _t(xs)),
           jax.vmap(lambda v: jmeasure.project_all(params, v))(xs))


def test_torch_normalize_and_predict(params, state_xP):
    x, P = state_xP
    x = x.at[3:7].multiply(1.01)      # so that the renorm acts
    st = j_init_state(K)._replace(x=x, P=P, lm_active=jnp.ones((K,), bool))
    want = jpredict.normalize_and_predict(params, st)
    got = tpredict.normalize_and_predict(interop.params_from_numpy(_np(params),
                                                                   device="cpu"),
                                         interop.state_from_numpy(_np(st), device="cpu"))
    _close(got.x, want.x)
    _close(got.P, want.P)
    assert torch.equal(got.P, got.P.T)


def _freed_slots_state(repres, capacity=12, n_free=4):
    """tests/test_recruit_fused.py's _setup: the GT bootstrap of scenario03
    with the tail slots removed, at frame 1 (no warm frames: with XYZ slots
    JAX's warm frames are already NaN). A freed XYZ slot sits at the origin,
    where the camera still is, so its projection is NaN."""
    dtype = jnp.float64
    sc = build_oscillating_scenario(capacity=capacity, dtype=dtype)
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                               (0.01, 0.01), dtype=dtype)
    params = j_make_params(cam, None, dt=1.0,
                           process_noise_lin_veloc_std=0.075,
                           process_noise_ang_veloc_std=0.01,
                           sal_pnt_init_inv_dist=0.5,
                           sal_pnt_init_inv_dist_std=0.4,
                           sal_pnt_repres=repres, dtype=dtype)
    state = init_with_gt_landmarks(params, sc, j_init_state(capacity, dtype=dtype),
                                   jax.random.PRNGKey(0))
    state = jlm.remove_landmarks(state, jnp.arange(capacity) >= capacity - n_free)
    obs, vis = _project_gt(params, sc, jnp.asarray(1), jax.random.PRNGKey(11))
    return params, state, obs, vis & state.lm_active


@pytest.mark.parametrize("repres", [1, 2])
def test_torch_masked_nonfinite_rows_contribute_zeros(repres):
    params, state, obs, m = _freed_slots_state(repres)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    args_t = (tp, _t(state.x), _t(state.P), _t(obs), _t(m))
    h = np.asarray(jmeasure.measurement_jacobians(params, state.x)[0])
    fused_j = jfs.fused_update_health_predict(params, state.x, state.P, obs, m)
    stacked_j = jupdate.stacked_update(params, state.x, state.P, obs, m)
    fused_t = tfs.fused_update_health_predict(*args_t)
    stacked_t = tupdate.stacked_update(*args_t)
    for out in (fused_t, stacked_t):
        assert bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all())
        assert torch.equal(out[1], out[1].T)
        assert int(out[-1]) == 0
    if repres == 1:
        # the freed slots' pixels are NaN, and JAX's updates are NaN throughout
        assert not np.isfinite(h[~np.asarray(state.lm_active)]).any()
        for out in (fused_j, stacked_j):
            assert np.isnan(np.asarray(out[0])).all()
            assert np.isnan(np.asarray(out[1])).all()
        # the port's update is the one of the active slots alone
        act = np.flatnonzero(np.asarray(state.lm_active))
        idx = np.concatenate([np.arange(N)] + [N + 6 * k + np.arange(6)
                                                for k in act])
        sub = dict(x=state.x[idx], P=state.P[idx][:, idx])
        ref = jupdate.stacked_update(params, sub["x"], sub["P"], obs[act],
                                     m[act])
        _close(stacked_t[0].numpy()[idx], ref[0], rtol=1e-10, atol=1e-10)
        _close(stacked_t[1].numpy()[np.ix_(idx, idx)], ref[1], rtol=1e-10,
               atol=1e-10)
    else:
        assert np.isfinite(h).all()
        for a, b in zip(fused_t[:4], fused_j):
            _close(a, b, rtol=1e-10, atol=1e-10)
        for a, b in zip(stacked_t[:3], stacked_j):
            _close(a, b, rtol=1e-10, atol=1e-10)
