"""The port's landmark-sharded imageseq closed loop (distributed render,
local NCC search, the sharded fused congruence with recruitment and the
delete policy; ``parallel/sharded_imageseq``) on gloo ranks against the
JAX sharded runner on an n-device mesh, on tests/test_parallel_imageseq.py's
worlds: every discrete decision equal, the state within 1e-9 (that file's
tolerances).

One group of 4 CPU ranks serves the file."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.parallel import landmark_mesh
from surikatoko_tpu.parallel.sharded_imageseq import (
    make_sharded_imageseq_runner as j_runner)
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.parallel import launch
from surikatoko_tpu_torch.parallel.sharded_imageseq import (
    make_sharded_imageseq_runner as t_runner)

from test_parallel_imageseq import _setup, _setup_churn

FRAMES = list(range(1, 13))


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(4, device="cpu") as p:
        yield p


def _port(params, sc, st, templates):
    np_ = lambda a: torch.as_tensor(np.array(a))
    return (interop.params_from_numpy(params, device="cpu"),
            interop.scenario_from_numpy(sc, device="cpu"),
            interop.state_from_numpy(st, device="cpu"), np_(templates))


def _state_close(x2, P2, jx, jP):
    np.testing.assert_allclose(x2, np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(P2, np.asarray(jP), rtol=1e-7, atol=1e-10)
    np.testing.assert_array_equal(P2, P2.T)


def test_torch_sharded_imageseq_matches_jax_mesh(pool):
    params, sc, st, templates = _setup()
    n = 2
    jx, jP, jact, junobs, (jerr, jn, jpos) = j_runner(
        params, st.capacity, landmark_mesh(n), templ_width=15,
        use_pallas=False)(st.x, st.P, templates, st.lm_active,
                          st.lm_unobserved, sc, jnp.asarray(FRAMES))
    tp, tsc, tst, ttm = _port(params, sc, st, templates)
    outs = pool.run(launch.call_with_group, n, t_runner, (tp, st.capacity),
                    (tst.x, tst.P, ttm, tst.lm_active, tst.lm_unobserved,
                     tsc, FRAMES), make_kwargs=dict(templ_width=15))
    x2, P2, act2, unobs2, (err2, n2, pos2, info2) = launch.first(outs[:n])
    np.testing.assert_array_equal(n2, np.asarray(jn))
    np.testing.assert_array_equal(act2, np.asarray(jact))
    np.testing.assert_array_equal(unobs2, np.asarray(junobs))
    np.testing.assert_allclose(err2, np.asarray(jerr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(pos2, np.asarray(jpos), rtol=0, atol=1e-9)
    assert not info2.any()
    _state_close(x2, P2, jx, jP)


@pytest.mark.parametrize("n,depth", [(2, "prior"), (4, "local")])
def test_torch_sharded_imageseq_recruit_matches_jax_mesh(pool, n, depth):
    """The churned loop: slot 3's template killed forces a delete and a
    re-recruit into the freed slot; recruits, generations, templates and
    active counts equal the JAX sharded loop's."""
    params, sc, st, templates = _setup_churn()
    templates = templates.at[3].set(0.0)
    kw = dict(templ_width=15, recruit=True, recruit_max=4,
              detector_corners=24, recruit_depth=depth)
    jx, jP, jtm, jact, junobs, jgen, (jerr, jn, jpos, jnrec, jnact) = \
        j_runner(params, st.capacity, landmark_mesh(n), use_pallas=False,
                 **kw)(st.x, st.P, templates, st.lm_active, st.lm_unobserved,
                       st.lm_generation, sc, jnp.asarray(FRAMES))
    assert int(jnp.sum(jnrec)) >= 3
    tp, tsc, tst, ttm = _port(params, sc, st, templates)
    outs = pool.run(launch.call_with_group, n, t_runner, (tp, st.capacity),
                    (tst.x, tst.P, ttm, tst.lm_active, tst.lm_unobserved,
                     tst.lm_generation, tsc, FRAMES), make_kwargs=kw)
    (x2, P2, tm2, act2, unobs2, gen2,
     (err2, n2, pos2, nrec2, nact2, info2)) = launch.first(outs[:n])
    for got, want in ((nrec2, jnrec), (nact2, jnact), (n2, jn),
                      (act2, jact), (unobs2, junobs), (gen2, jgen)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(tm2, np.asarray(jtm), rtol=0, atol=1e-12)
    np.testing.assert_allclose(err2, np.asarray(jerr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(pos2, np.asarray(jpos), rtol=0, atol=1e-9)
    assert not info2.any()
    _state_close(x2, P2, jx, jP)


def test_torch_sharded_imageseq_delete_policy_fires(pool):
    """A slot whose template never matches is dropped on every rank: its
    covariance rows are zero and the run equals the JAX sharded loop."""
    params, sc, st, templates = _setup()
    templates = templates.at[3].set(0.0)
    frames = list(range(1, 9))
    jx, jP, jact, _, _ = j_runner(
        params, st.capacity, landmark_mesh(4), templ_width=15,
        use_pallas=False)(st.x, st.P, templates, st.lm_active,
                          st.lm_unobserved, sc, jnp.asarray(frames))
    tp, tsc, tst, ttm = _port(params, sc, st, templates)
    outs = pool.run(launch.call_with_group, 4, t_runner, (tp, st.capacity),
                    (tst.x, tst.P, ttm, tst.lm_active, tst.lm_unobserved,
                     tsc, frames), make_kwargs=dict(templ_width=15))
    x2, P2, act2, _, _ = launch.first(outs)
    assert not act2[3]
    np.testing.assert_array_equal(act2, np.asarray(jact))
    off = 13 + 3 * 6
    assert np.abs(P2[off:off + 6, :]).max() == 0.0
    _state_close(x2, P2, jx, jP)


def test_torch_sharded_parity_checks_hold(pool):
    """parallel.parity.sharded_parity, the card's sharded checks, at a small
    size on 4 ranks: every check holds (P equal to the single-device P
    within 1e-9 in float64 here: the CPU's plain slab is not the card's
    kernel), the BA's band plan engages, and the ranks agree."""
    from surikatoko_tpu_torch.parallel import parity
    outs = pool.run(launch.call_with_group, 4, parity.sharded_parity, (),
                    None, dict(device="cpu", capacity=64, n_points=128,
                               frames=range(1, 4), timed=range(4, 6),
                               ba_size=(768, 48, 12)))
    for o in outs:
        assert o["ranks"] == 4 and o["backend"] == "gloo"
        assert all(o["checks"].values()), o["checks"]
        assert o["ba"]["plan_engaged"]
        for t in ("float64", "float32"):
            assert o[f"fused_{t}"]["P_checksum"] == \
                outs[0][f"fused_{t}"]["P_checksum"]
    assert outs[0]["imageseq"]["sharded_pallas_matched_absdiff"] == 0
