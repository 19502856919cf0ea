"""The port's point-sharded Schur solves (``parallel/sharded_schur``) on
gloo ranks against the JAX sharded solvers on an n-device mesh
(tests/test_parallel_schur.py's and test_parallel_schur_sparse.py's
problems and tolerances): dense, sparse unbanded and banded;
``sparse.plan_bands_sharded`` equal to the JAX plan; the group form of
``SparseBundleAdjustment``; and test_mvf_sparse.py's mesh case, the
multi-view factorizer with its sparse BA sharded over 2 ranks.

One group of 4 CPU ranks serves the file."""

import functools

import jax
import numpy as np
import pytest
import torch

from surikatoko_tpu.models.ba import derivs as jderivs
from surikatoko_tpu.models.ba import sparse as jsp
from surikatoko_tpu.parallel import landmark_mesh
from surikatoko_tpu.parallel.sharded_schur import (
    make_sharded_schur_solver as j_dense,
    make_sharded_sparse_schur_solver as j_sparse)
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.demos import multi_view_factorization as tdemo
from surikatoko_tpu_torch.models.ba import TermCriteria
from surikatoko_tpu_torch.models.ba import derivs as tderivs
from surikatoko_tpu_torch.models.ba import problem as tproblem
from surikatoko_tpu_torch.models.ba import sparse as tsp
from surikatoko_tpu_torch.parallel import launch
from surikatoko_tpu_torch.parallel import sharded_schur as ss

from test_ba_sparse import _local_track_problem
from test_parallel_schur import _padded_problem
from test_parallel_schur_sparse import _padded_sparse

TOL = dict(rtol=1e-8, atol=1e-12)


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(4, device="cpu") as p:
        yield p


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _first(outs, n):
    assert all(o is None for o in outs[n:])
    return launch.first(outs[:n])


@pytest.mark.parametrize("n", [2, 4])
def test_torch_sharded_dense_schur_matches_jax_mesh(pool, n):
    p = _padded_problem()
    jdX, jdu, jok = j_dense(p.n_points, p.n_frames, landmark_mesh(n))(
        jderivs.compute_blocks(p), 1e-4)
    assert bool(jok)
    pt = interop.ba_problem_from_numpy(_np(p), device="cpu")
    dX, du, ok = _first(pool.run(
        launch.call_with_group, n, ss.make_sharded_schur_solver,
        (p.n_points, p.n_frames), (tderivs.compute_blocks(pt), 1e-4)), n)
    assert ok
    np.testing.assert_allclose(du, np.asarray(jdu), **TOL)
    np.testing.assert_allclose(dX, np.asarray(jdX), **TOL)


def test_torch_sharded_ba_step_decreases_error(pool):
    p = _padded_problem()
    pt = interop.ba_problem_from_numpy(_np(p), device="cpu")
    p1, ok = _first(pool.run(launch.call_with_group, 4, ss.make_sharded_ba_step,
                             (p.n_points, p.n_frames), (pt, 1e-4)), 4)
    assert ok
    p1 = type(pt)(*(torch.as_tensor(a) for a in p1))
    assert float(tproblem.reproj_error(p1)) < float(tproblem.reproj_error(pt))


def test_torch_sharded_sparse_schur_matches_jax_mesh(pool):
    ps = _padded_sparse()
    n = 2
    jdX, jdu, jok = j_sparse(ps.n_points, ps.n_frames, ps.track_len,
                             landmark_mesh(n), point_chunk=8)(
        ps, jax.jit(jsp.compute_blocks)(ps), 1e-4)
    assert bool(jok)
    pt = interop.sparse_problem_from_numpy(_np(ps), device="cpu")
    dX, du, ok = _first(pool.run(
        launch.call_with_group, n, ss.make_sharded_sparse_schur_solver,
        (ps.n_points, ps.n_frames, ps.track_len),
        (pt, tsp.compute_blocks(pt), 1e-4), dict(point_chunk=8)), n)
    assert ok
    np.testing.assert_allclose(du, np.asarray(jdu), **TOL)
    np.testing.assert_allclose(dX, np.asarray(jdX), **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_torch_sharded_banded_schur_matches_jax_mesh(pool, n):
    """Per-shard banded reductions (the plan equal to JAX's) against the
    JAX banded sharded solve."""
    ps = _local_track_problem(np.random.default_rng(3), Np=512, F=48, L=8)
    jplan = jsp.plan_bands_sharded(ps.frame_idx, ps.obs_mask, n, 32,
                                   ps.n_frames)
    tplan = tsp.plan_bands_sharded(np.asarray(ps.frame_idx),
                                   np.asarray(ps.obs_mask), n, 32, ps.n_frames)
    assert jplan is not None and jplan.band_width < ps.n_frames
    np.testing.assert_array_equal(tplan.ext_idx, np.asarray(jplan.ext_idx))
    assert (tplan.band_width, tplan.n_banded_chunks, tplan.overflow_chunk,
            tplan.point_chunk) == (jplan.band_width, jplan.n_banded_chunks,
                                   jplan.overflow_chunk, jplan.point_chunk)
    assert len(tplan.bases) == n
    jdX, jdu, jok = j_sparse(ps.n_points, ps.n_frames, ps.track_len,
                             landmark_mesh(n), point_chunk=32,
                             band_plan=jplan)(
        ps, jax.jit(jsp.compute_blocks)(ps), 1e-4)
    assert bool(jok)
    pt = interop.sparse_problem_from_numpy(_np(ps), device="cpu")
    dX, du, ok = _first(pool.run(
        launch.call_with_group, n, ss.make_sharded_sparse_schur_solver,
        (ps.n_points, ps.n_frames, ps.track_len),
        (pt, tsp.compute_blocks(pt), 1e-4),
        dict(point_chunk=32, band_plan=tplan)), n)
    assert ok
    np.testing.assert_allclose(du, np.asarray(jdu), **TOL)
    np.testing.assert_allclose(dX, np.asarray(jdX), **TOL)


def test_torch_sharded_lm_uses_banding_on_local_problem(pool):
    """SparseBundleAdjustment(group=..., band=True) plans per-shard banding
    and takes the unbanded distributed path's steps
    (test_parallel_schur_sparse.py's banded LM case)."""
    ps = _local_track_problem(np.random.default_rng(4), Np=512, F=48, L=8,
                              noise=0.05)
    pt = interop.sparse_problem_from_numpy(_np(ps), device="cpu")
    term = TermCriteria(allowed_reproj_err_rel_change=1e-12, max_iters=8)
    run = functools.partial(pool.run, launch.call_with_group, 4,
                            ss.run_sparse_ba, (pt, term))
    u = _first(run(None, dict(point_chunk=32, band=False)), 4)
    b = _first(run(None, dict(point_chunk=32, band=True)), 4)
    assert b["banded"] and not u["banded"]
    path = lambda r: (r["ok"], r["stop_reason"], r["iterations"])  # noqa: E731
    assert path(b) == path(u)
    np.testing.assert_allclose(b["err"], u["err"], rtol=1e-8)
    # and the single-process LM, on the same problem
    single = ss.run_sparse_ba(pt, term, point_chunk=32, band=True)
    assert path(single) == path(b)
    np.testing.assert_allclose(b["err"], float(single["err"]), rtol=1e-8)


def test_torch_mvf_sparse_ba_distributed_matches_local(pool):
    """test_mvf_sparse_ba_distributed_matches_local on the port: the MVF
    demo's noisy world with its sparse BA point-sharded over 2 ranks gives
    the map and the trajectory of the single-process run."""
    kw = dict(frames=10, noise_pix=0.5, seed=3, device="cpu",
              dtype=torch.float64, use_sparse_ba=True)
    tids_l, pts_l, pos_l, m_l = tdemo.run_map(**kw)
    assert m_l["ba_runs"] >= 1
    outs = pool.run(launch.call_with_group, 2, tdemo.run_map, (), None,
                    dict(kw, ba_point_chunk=32, ba_device_loop=False))
    # both ranks build the same map (their metrics hold their own timings)
    launch.first([o[:3] for o in outs[:2]])
    tids_m, pts_m, pos_m, m_m = outs[0]
    np.testing.assert_array_equal(tids_m, tids_l)
    assert m_m["ba_runs"] == m_l["ba_runs"]
    np.testing.assert_allclose(pts_m, pts_l, atol=1e-6)
    np.testing.assert_allclose(pos_m, pos_l, atol=1e-6)


def test_torch_mvf_group_needs_host_loop():
    """A factorizer with ba_group refuses the device LM loop, as the group
    form of SparseBundleAdjustment does."""
    from surikatoko_tpu_torch.models.mvf import MultiViewFactorizer, TrackStore
    with pytest.raises(ValueError, match="ba_device_loop must be False"):
        MultiViewFactorizer(TrackStore(8, 4), np.eye(3), ba_group=object(),
                            device="cpu")


def _medium_port(rng):
    """test_sparse_medium_scale_smoke's problem (800 points x 40 frames,
    tracks of 8 wrapping around the circle) built from the port's world,
    the same draws in the same order."""
    from surikatoko_tpu_torch.world import scene_gen
    Np, F, L = 800, 40, 8
    pts = rng.uniform(-2, 2, size=(Np, 3)) + np.array([0, 0, 4.0])
    K = np.array([[500.0, 0, 160.0], [0, 500.0, 120.0], [0, 0, 1.0]])
    cfw = scene_gen.circle_camera_shots(
        (0, 0, 4.0), 8.0, 2.0, np.linspace(0, 2 * np.pi, F, endpoint=False))
    Rs, ts = cfw.R.numpy(), cfw.t.numpy()
    obs = np.zeros((Np, L, 2))
    fidx = np.zeros((Np, L), np.int64)
    mask = np.zeros((Np, L), bool)
    for i in range(Np):
        start = rng.integers(0, F)
        for l in range(L):
            f = (start + l) % F
            xc = Rs[f] @ pts[i] + ts[f]
            if xc[2] < 0.5:
                continue
            ph = K @ xc
            obs[i, l] = ph[:2] / ph[2] + rng.normal(scale=0.3, size=2)
            fidx[i, l] = f
            mask[i, l] = True
    t = torch.as_tensor
    return tsp.BAProblemSparse(
        points=t(pts + rng.normal(scale=0.02, size=pts.shape)),
        cfw_R=t(Rs), cfw_t=t(ts), K=t(K).expand(F, 3, 3).contiguous(),
        obs=t(obs), frame_idx=t(fidx), obs_mask=t(mask),
        f0=torch.tensor(1.0, dtype=torch.float64))


def test_torch_sharded_medium_scale_matches_jax(pool):
    """test_ba_sparse.py's medium-scale case from the port's own world
    (equal to the JAX problem), its wrap-around tracks refused by the
    sharded band plan, and the point-sharded solve on 4 ranks equal to the
    JAX single-device sparse solve (test_torch_ba_sparse.py's tolerance)."""
    from test_torch_ba_sparse import SOLVE_TOL, _jblocks, _jfull, _medium_problem
    psj = _medium_problem(np.random.default_rng(20260817))
    pt = _medium_port(np.random.default_rng(20260817))
    for name in ("points", "cfw_R", "cfw_t", "K", "obs", "frame_idx",
                 "obs_mask"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(psj, name)), rtol=0,
                                   atol=1e-12, err_msg=name)
    assert tsp.plan_bands_sharded(pt.frame_idx.numpy(), pt.obs_mask.numpy(),
                                  4, 2048, 40) is None
    jdX, jdu, _ = _jfull(psj, _jblocks(psj), 1e-4)
    dX, du, ok = _first(pool.run(
        launch.call_with_group, 4, ss.make_sharded_sparse_schur_solver,
        (800, 40, 8), (pt, tsp.compute_blocks(pt), 1e-4)), 4)
    assert ok
    np.testing.assert_allclose(du, np.asarray(jdu), **SOLVE_TOL)
    np.testing.assert_allclose(dX, np.asarray(jdX), **SOLVE_TOL)
