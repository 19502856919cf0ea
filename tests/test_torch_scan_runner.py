"""The ported scenario03 GT-matcher scan runner against the JAX package, in
float64 on the CPU: the GT bootstrap at 1e-12, then every update impl on
tests/test_device_runner.py::test_scan_runner_all_update_impls's inputs
(capacity 16, 30 frames, the noise JAX draws from PRNGKey(1) handed to the
port as an array) and impl 1 on test_scan_runner_tracks's (capacity 32, 60
frames): per-frame residual norms and camera positions at 1e-8, matched
counts equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.models.monoslam import init_state as j_init_state
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.world import device_runner as jdr
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.world import device_runner as tdr

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(capacity):
    dtype = jnp.float64
    sc = jdr.build_oscillating_scenario(capacity=capacity, dtype=dtype)
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                               (0.01, 0.01), dtype=dtype)
    params = j_make_params(cam, None, dt=1.0,
                           process_noise_lin_veloc_std=0.075,
                           process_noise_ang_veloc_std=0.01, dtype=dtype)
    state = jdr.init_with_gt_landmarks(params, sc, j_init_state(capacity, dtype=dtype),
                                       jax.random.PRNGKey(0))
    return params, sc, state


@pytest.fixture(scope="module")
def world16():
    return _setup(16)


def test_torch_init_with_gt_landmarks(world16):
    """The same bootstrap from the same detection noise: JAX draws it from
    PRNGKey(0) inside, the port takes the draws."""
    params, sc, state_j = world16
    noise = jax.random.normal(jax.random.PRNGKey(0), (16, 2), jnp.float64)
    tp = interop.params_from_numpy(_np(params), device="cpu")
    state_t = tdr.init_with_gt_landmarks(
        tp, interop.scenario_from_numpy(_np(sc), device="cpu"),
        interop.state_from_numpy(_np(j_init_state(16, dtype=jnp.float64)), device="cpu"),
        torch.as_tensor(np.array(noise)))
    np.testing.assert_array_equal(state_t.lm_active.numpy(),
                                  np.asarray(state_j.lm_active))
    assert int(state_t.lm_active.sum()) >= 8
    for a, b in ((state_t.x, state_j.x), (state_t.P, state_j.P)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    assert torch.equal(state_t.P, state_t.P.T)


def _compare_runs(params, sc, state, frames, impl):
    T = len(frames)
    K = state.capacity
    run_j = jdr.make_scan_runner(params, update_impl=impl)
    _, errs_j, n_j, pos_j = run_j(state, sc, jnp.asarray(frames),
                                  jax.random.PRNGKey(1))
    # the standard-normal draws run_j scales by sc.noise_std
    noise = jax.random.normal(jax.random.PRNGKey(1), (T, K, 2), jnp.float64)
    run_t = tdr.make_scan_runner(interop.params_from_numpy(_np(params), device="cpu"),
                                 update_impl=impl)
    st_t, errs_t, n_t, pos_t, info_t = run_t(
        interop.state_from_numpy(_np(state), device="cpu"),
        interop.scenario_from_numpy(_np(sc), device="cpu"),
        frames, torch.as_tensor(np.array(noise)))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(errs_t.numpy(), np.asarray(errs_j), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=0,
                               atol=1e-8)
    assert int(torch.count_nonzero(info_t)) == 0
    assert torch.equal(st_t.P, st_t.P.T)
    # and it tracks (test_device_runner's bound)
    gt_pos = -np.einsum("fji,fj->fi", np.asarray(sc.gt_cfw_R)[frames],
                        np.asarray(sc.gt_cfw_t)[frames])
    assert np.linalg.norm(pos_t.numpy() - gt_pos, axis=1).max() < 0.5


@pytest.mark.parametrize("impl", [1, 2, 3, 4])
def test_torch_scan_runner_matches_jax(world16, impl):
    params, sc, state = world16
    _compare_runs(params, sc, state, list(range(1, 31)), impl)


def test_torch_scan_runner_impl1_capacity32_60_frames():
    params, sc, state = _setup(32)
    _compare_runs(params, sc, state, list(range(1, 61)), 1)


def test_torch_scan_runner_rejects_unknown_impl(world16):
    tp = interop.params_from_numpy(_np(world16[0]), device="cpu")
    with pytest.raises(ValueError, match="update_impl"):
        tdr.make_scan_runner(tp, update_impl=5)
