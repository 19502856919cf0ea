"""The port's landmark-sharded FUSED frame step (update + health + predict
as one congruence, ``parallel/sharded_ekf``) on 2, 4 and 8 gloo ranks
against the JAX sharded fused step on an n-device mesh
(tests/test_parallel_fused.py's cases and tolerances): with and without
the diagonal inflation, a 5-frame loop, and the recruit splice against
the single-device fused recruit step of both packages. The sharded P is
exactly symmetric with no repair pass.

One group of 8 CPU ranks serves the file."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.models.monoslam import measure as jmeasure
from surikatoko_tpu.models.monoslam import fused_step as jfs
from surikatoko_tpu.parallel import landmark_mesh
from surikatoko_tpu.parallel.sharded_ekf import (
    make_sharded_fused_step as j_sharded_fused)
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.parallel import launch
from surikatoko_tpu_torch.parallel import sharded_ekf as se

from test_parallel_ekf import K, rand_problem

TOL = dict(rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(8, device="cpu") as p:
        yield p


def _jparams(inflation=None, distortion=True):
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01))
    if inflation is not None:
        return j_make_params(cam, None, dt=1.0, covar_diag_inflation=inflation)
    dist = (jcam.MikhailDistortion(jnp.float64(0.06), jnp.float64(0.01))
            if distortion else None)
    return j_make_params(cam, dist, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01)


def _case(jp, seed, all_observed):
    rng = np.random.default_rng(seed)
    x, P = rand_problem(rng)
    mask = (np.ones(K, bool) if all_observed
            else rng.uniform(size=K) < 0.8)
    obs = np.asarray(jmeasure.project_all(jp, x)) + rng.normal(
        scale=0.5 if all_observed else 1.0, size=(K, 2))
    return np.asarray(x), np.asarray(P), obs, mask


def _run(pool, n, make, params, *args):
    outs = pool.run(launch.call_with_group, n, make, (params, K),
                    tuple(torch.as_tensor(np.array(a)) for a in args))
    assert all(o is None for o in outs[n:])
    return launch.first(outs[:n])


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("inflation", [None, 1e-4])
def test_torch_sharded_fused_step_matches_jax_mesh(pool, n, inflation):
    jp = _jparams(inflation)
    x, P, obs, mask = _case(jp, 20260817 + n, inflation is not None)
    jx, jP, jr, jxm = j_sharded_fused(jp, K, landmark_mesh(n))(
        jnp.asarray(x), jnp.asarray(P), jnp.asarray(obs), jnp.asarray(mask))
    params = interop.params_from_numpy(jp, device="cpu")
    tx, tP, tr, txm, info = _run(pool, n, se.make_sharded_fused_step, params,
                                 x, P, obs, mask)
    np.testing.assert_allclose(tx, np.asarray(jx), **TOL)
    np.testing.assert_allclose(tP, np.asarray(jP), **TOL)
    np.testing.assert_allclose(tr, np.asarray(jr).reshape(K, 2), atol=1e-12)
    np.testing.assert_allclose(txm, np.asarray(jxm), **TOL)
    assert int(info) == 0
    # B2's rows: exactly symmetric with no repair pass
    np.testing.assert_array_equal(tP, tP.T)


def test_torch_sharded_fused_loop_matches_jax_single(pool):
    """Five frames of the sharded step (every rank feeding its output back)
    against the JAX single-device fused step in a host loop
    (test_sharded_fused_step_scan_compatible's tolerance)."""
    jp = _jparams()
    rng = np.random.default_rng(5)
    x, P = rand_problem(rng)
    mask = np.ones(K, bool)
    h0 = np.asarray(jmeasure.project_all(jp, x))
    obs_seq = h0[None] + rng.normal(scale=0.5, size=(5, K, 2))
    xs, Ps = x, P
    for t in range(5):
        xs, Ps, _, _ = jfs.fused_update_health_predict(
            jp, xs, Ps, jnp.asarray(obs_seq[t]), jnp.asarray(mask))
    params = interop.params_from_numpy(jp, device="cpu")
    outs = pool.run(launch.call_with_group, 8, se.make_sharded_fused_loop,
                    (params, K), (torch.as_tensor(np.asarray(x)),
                                  torch.as_tensor(np.asarray(P)),
                                  torch.as_tensor(obs_seq),
                                  torch.as_tensor(mask)))
    xf, Pf, costs = launch.first(outs)
    np.testing.assert_allclose(xf, np.asarray(xs), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Pf, np.asarray(Ps), rtol=0, atol=1e-9)
    assert np.isfinite(costs).all()
    np.testing.assert_array_equal(Pf, Pf.T)


@pytest.mark.parametrize("n", [2, 4])
def test_torch_sharded_fused_recruit_matches_jax_single(pool, n):
    """The recruit splice on the ranks (replicated recruit math, the owner
    rank writing the new rows, every rank the new columns) against the JAX
    single-device fused recruit step: slots equal, state within 1e-10."""
    jp = _jparams()
    rng = np.random.default_rng(11 + n)
    x, P = rand_problem(rng)
    mask = rng.uniform(size=K) < 0.8
    obs = np.asarray(jmeasure.project_all(jp, x)) + rng.normal(size=(K, 2))
    free = np.zeros(K, bool)
    free[[2, 5, 9, 14]] = True          # slots on several ranks
    drop = np.zeros(K, bool)
    drop[[5]] = True
    new_pix = rng.uniform((20, 20), (300, 220), size=(3, 2))
    new_valid = np.array([True, False, True])
    jout = jfs.fused_update_health_recruit_predict(
        jp, jnp.asarray(x), jnp.asarray(P), jnp.asarray(obs),
        jnp.asarray(mask), jnp.asarray(new_pix), jnp.asarray(new_valid),
        jnp.asarray(free), deactivate_mask=jnp.asarray(drop))
    params = interop.params_from_numpy(jp, device="cpu")
    tx, tP, tr, txm, slots, info = _run(
        pool, n, se.make_sharded_fused_recruit_step, params, x, P, obs, mask,
        new_pix, new_valid, free, drop)
    np.testing.assert_array_equal(slots, np.asarray(jout[4]))
    assert (slots >= 0).sum() == 2
    np.testing.assert_allclose(tx, np.asarray(jout[0]), **TOL)
    np.testing.assert_allclose(tP, np.asarray(jout[1]), **TOL)
    np.testing.assert_allclose(txm, np.asarray(jout[3]), **TOL)
    np.testing.assert_array_equal(tP, tP.T)
