"""The port's landmark-sharded stacked update (``parallel/sharded_ekf``) on
2, 4 and 8 gloo ranks against the JAX sharded update on an n-device mesh
(tests/test_parallel_ekf.py's problems and tolerance), and B2's row slab on
the ranks bit for bit the full downdate (P == P^T on the assembled rows).

One group of 8 CPU ranks serves the file (``launch.RankPool``); a rank
imports torch and the port only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.models.monoslam import measure as jmeasure
from surikatoko_tpu.models.monoslam import update as jupdate
from surikatoko_tpu.parallel import landmark_mesh
from surikatoko_tpu.parallel.sharded_ekf import (
    make_sharded_stacked_update as j_sharded_update)
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.models.monoslam import update as tupdate
from surikatoko_tpu_torch.parallel import launch
from surikatoko_tpu_torch.parallel import sharded_ekf as se

from test_parallel_ekf import K, rand_problem

TOL = dict(rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(8, device="cpu") as p:
        yield p


def _jparams():
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01))
    dist = jcam.MikhailDistortion(jnp.float64(0.06), jnp.float64(0.01))
    return j_make_params(cam, dist, dt=1.0)


def _case(seed, all_observed):
    rng = np.random.default_rng(seed)
    x, P = rand_problem(rng)
    jp = _jparams()
    mask = (np.ones(K, bool) if all_observed
            else rng.uniform(size=K) < 0.8)
    obs = np.asarray(jmeasure.project_all(jp, x)) + rng.normal(
        scale=0.5 if all_observed else 1.0, size=(K, 2))
    return jp, np.asarray(x), np.asarray(P), obs, mask


def _torch(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("all_observed", [False, True])
def test_torch_sharded_update_matches_jax_mesh(pool, n, all_observed):
    jp, x, P, obs, mask = _case(20260817 + n, all_observed)
    jx, jP, jr = j_sharded_update(jp, K, landmark_mesh(n))(
        jnp.asarray(x), jnp.asarray(P), jnp.asarray(obs), jnp.asarray(mask))
    params = interop.params_from_numpy(jp, device="cpu")
    outs = pool.run(launch.call_with_group, n, se.make_sharded_stacked_update,
                    (params, K), _torch(x, P, obs, mask))
    assert all(o is None for o in outs[n:])
    tx, tP, tr, info = launch.first(outs[:n])
    np.testing.assert_allclose(tx, np.asarray(jx), **TOL)
    np.testing.assert_allclose(tP, np.asarray(jP), **TOL)
    np.testing.assert_allclose(tr, np.asarray(jr).reshape(K, 2), atol=1e-12)
    assert int(info) == 0
    np.testing.assert_array_equal(tP, tP.T)


def test_torch_sharded_update_matches_single_device_port(pool):
    """The ranks' rows are B2's rows: the sharded update equals the port's
    single-device stacked update within its own rounding of A = H P."""
    jp, x, P, obs, mask = _case(7, False)
    params = interop.params_from_numpy(jp, device="cpu")
    ref = tupdate.stacked_update(params, *_torch(x, P, obs, mask))
    outs = pool.run(launch.call_with_group, 4, se.make_sharded_stacked_update,
                    (params, K), _torch(x, P, obs, mask))
    tx, tP = launch.first(outs[:4])[:2]
    np.testing.assert_allclose(tx, ref[0].numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(tP, ref[1].numpy(), rtol=0, atol=1e-14)

