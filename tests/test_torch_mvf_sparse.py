"""The factorizer's noisy runs and its BA backends, port against the JAX
package in float64 on the CPU: test_mvf.py's noisy world (10 frames, 0.3 px,
seed 3) frame by frame, tests/test_mvf_sparse.py:25-95 (the padded-track
problem against the dense grid, the sparse BA backend against the dense
one, the automatic switch; the JAX package's mesh case waits for the
port's distribution layer), and the sliding-window BA on a carried state.

Tolerances. On this world the first BA runs (3 to 5 frames) are
ill-conditioned: the JAX package itself moves its map by up to 1.3e-6
when its input moves by 1e-15 (relative). Each frame is therefore held to
max(1e-8, 10 x that spread of the JAX package, measured here on a second
JAX run of the world scaled by 1 + 1e-15); from frame 6 on that is 1e-8.
Every BA's (kind, ok, stop reason, iterations, trials) is equal.
"""

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.geom.align import aligned_rmse
from surikatoko_tpu_torch.models.ba import problem as tproblem
from surikatoko_tpu_torch.models.ba import sparse as tsparse

from test_torch_mvf import MVF_TOL, compare, make_pair, run_world, snapshot

torch.set_num_threads(2)
NOISY = dict(noise_pix=0.3, seed=3)


def _spread(a: dict, b: dict) -> float:
    return compare(a, b, np.inf)


@pytest.fixture(scope="module")
def noisy():
    """(JAX dense run, port dense run, their snapshots, the JAX package's
    own per-frame spread under a 1e-15 change of the world)."""
    j, t = make_pair()
    snaps = run_world((j, t), **NOISY)
    j2, _ = make_pair()
    snaps2 = run_world((j2,), scale=1.0 + 1e-15, **NOISY)
    spread = [_spread(a[0], b[0]) for a, b in zip(snaps, snaps2)]
    return j, t, snaps, spread


@pytest.fixture(scope="module")
def jax_sparse():
    j, _ = make_pair(use_sparse_ba=True)
    return j, run_world((j,), **NOISY)


def test_torch_mvf_noisy_frame_by_frame_matches_jax(noisy):
    j, t, snaps, spread = noisy
    for f, ((a, b), s) in enumerate(zip(snaps, spread)):
        compare(a, b, max(MVF_TOL, 10.0 * s), f"frame {f}")
    compare(snaps[-1][0], snaps[-1][1], MVF_TOL, "last frame")
    assert t.ba_runs >= 1 and not t.last_ba_sparse
    assert [x[0] for x in t.ba_log] == ["dense"] * t.ba_runs
    points = np.asarray(make_pair.__globals__["make_world"](10)[0])
    tids = sorted(t.point_coords)
    est = np.stack([t.point_coords[k] for k in tids])
    assert float(aligned_rmse(torch.as_tensor(est),
                              torch.as_tensor(points[tids]))) < 0.1


def test_torch_sparse_problem_matches_dense_grid(noisy):
    """The port's padded-track emission against its dense grid (the same
    reprojection error and cells), and both against the JAX package's."""
    j, t, _, _ = noisy
    tids_d, pd = t._dense_problem()
    tids_s, ps = t._sparse_problem()
    assert tids_d == tids_s
    np.testing.assert_allclose(float(tproblem.reproj_error(pd)),
                               float(tsparse.reproj_error(ps)), rtol=1e-12)
    obs, fidx, msk = (ps.obs.numpy(), ps.frame_idx.numpy(),
                      ps.obs_mask.numpy())
    grid = np.zeros(pd.obs.shape)
    gm = np.zeros(pd.obs_mask.shape, bool)
    rows, ls = np.nonzero(msk)
    gm[rows, fidx[rows, ls]] = True
    grid[rows, fidx[rows, ls]] = obs[rows, ls]
    np.testing.assert_array_equal(gm, pd.obs_mask.numpy())
    np.testing.assert_array_equal(grid * gm[..., None],
                                  pd.obs.numpy() * gm[..., None])
    # the same state emits the same problem as the JAX package's
    jt, jps = j._sparse_problem()
    tc, cps = interop.mvf_from_numpy(j, device="cpu")._sparse_problem()
    assert jt == tc
    for name in ("points", "cfw_R", "cfw_t", "K", "obs", "frame_idx",
                 "obs_mask"):
        np.testing.assert_array_equal(getattr(cps, name).numpy(),
                                      np.asarray(getattr(jps, name)),
                                      err_msg=name)


def test_torch_mvf_sparse_ba_matches_jax_and_dense(noisy, jax_sparse):
    """use_sparse_ba=True: the port's run against the JAX package's sparse
    run frame by frame, and against the dense backend's map (5e-5, the JAX
    test's own bound)."""
    _, t_dense, dense_snaps, spread = noisy
    j, jsnaps = jax_sparse
    _, t = make_pair(use_sparse_ba=True)
    snaps = run_world((t,), **NOISY)
    for f, (a, b, s) in enumerate(zip(jsnaps, snaps, spread)):
        compare(a[0], b[0], max(MVF_TOL, 10.0 * s), f"frame {f}")
    assert t.last_ba_sparse and t.ba_runs == t_dense.ba_runs
    assert [x[0] for x in t.ba_log] == ["sparse"] * t.ba_runs
    compare(snaps[-1][0], dense_snaps[-1][1], 5e-5, "sparse vs dense")


@pytest.mark.parametrize("threshold,sparse", [(10, True), (10**9, False)])
def test_torch_mvf_auto_switch_matches_jax(noisy, jax_sparse, threshold,
                                           sparse):
    """use_sparse_ba=None: the backend flips on the Np*F dense-cell count;
    each run equals the JAX package's run of that backend."""
    _, t = make_pair(sparse_ba_threshold=threshold)
    snaps = run_world((t,), **NOISY)
    ref = jax_sparse[1] if sparse else [s[:1] for s in noisy[2]]
    for f, (a, b, s) in enumerate(zip(ref, snaps, noisy[3])):
        compare(a[0], b[0], max(MVF_TOL, 10.0 * s), f"frame {f}")
    assert t.ba_runs >= 1 and t.last_ba_sparse == sparse


def test_torch_run_windowed_ba_matches_jax(noisy):
    """The sliding-window BA (window 6, frames 0-1 of the window pinned) on
    the JAX noisy run's end state carried into the port."""
    j, _, _, _ = noisy
    t = interop.mvf_from_numpy(j, device="cpu")
    j.ba_max_iters = t.ba_max_iters = 20
    j.ba_term_rel_change = t.ba_term_rel_change = 1e-9
    before = snapshot(t)
    ok_j = j.run_windowed_ba(window=6, point_bucket=32)
    ok_t = t.run_windowed_ba(window=6, point_bucket=32)
    assert ok_j and ok_t
    kind, ok, stop, iters, trials = t.ba_log[-1]
    assert (kind, ok, iters >= 1) == ("window", True, True)
    a, b = snapshot(j), snapshot(t)
    compare(a, b, MVF_TOL, "windowed BA")
    # the window's first two frames are pinned, the frames before it too
    np.testing.assert_array_equal(b["t"][:6], before["t"][:6])
    assert np.abs(b["t"][6:] - before["t"][6:]).max() > 0
    prof = t.profile["window_ba"]
    assert prof["runs"] == 1
    assert prof["per_run"][0][3:] == j.profile["window_ba"]["per_run"][0][3:]
