"""Sparse (track-major) bundle adjustment of the PyTorch port against the JAX
package, in float64 on the CPU: the inputs of tests/test_ba_sparse.py (the
circle-grid problem and the frame-local track problems) go through both.

Tolerances: blocks to rtol 1e-9; full-width and banded corrections to rtol
1e-7 / atol 1e-10 (test_ba_sparse.py's own); LM runs take the identical
path, (ok, stop_reason, iterations, trials), with the final error to rtol
1e-9. build_at_scale_problem equals the JAX demo's build_problem bit for
bit.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.models.ba import SparseBundleAdjustment as JSBA
from surikatoko_tpu.models.ba import TermCriteria as JTC
from surikatoko_tpu.models.ba import sparse as jsp
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.models.ba import SparseBundleAdjustment as TSBA
from surikatoko_tpu_torch.models.ba import TermCriteria as TTC
from surikatoko_tpu_torch.models.ba import derivs as td
from surikatoko_tpu_torch.models.ba import normalize as tn
from surikatoko_tpu_torch.models.ba import problem as tp
from surikatoko_tpu_torch.models.ba import schur as ts
from surikatoko_tpu_torch.models.ba import sparse as tsp
from surikatoko_tpu_torch.utils.profiling import counts
from surikatoko_tpu_torch.world import ba_scene

from test_ba import circle_grid_problem
from test_ba_sparse import _local_track_problem

torch.set_num_threads(2)
GRAPH_COUNTERS = ("ba.graph_captures", "ba.graph_replays")
BLOCK_TOL = dict(rtol=1e-9, atol=1e-12)
SOLVE_TOL = dict(rtol=1e-7, atol=1e-10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               **(tol or dict(rtol=1e-12, atol=1e-12)))


def _to_torch(psj):
    return interop.sparse_problem_from_numpy(_np(psj), device="cpu")


# the JAX side compiled, as its BA classes run it (eager op-by-op dispatch of
# the vmapped jacfwd takes seconds on the CPU)
_jblocks = jax.jit(jsp.compute_blocks, static_argnames=(
    "unity_comp_ind", "pin_frames", "optimize_intrinsics"))
_jfull = jax.jit(jsp.solve_corrections_schur_sparse, static_argnames=(
    "unity_comp_ind", "optimize_intrinsics", "point_chunk", "pin_frames"))


def _jbanded(psj, blocks, factor, plan):
    return jax.jit(functools.partial(jsp.solve_corrections_schur_banded,
                                     plan=plan))(psj, blocks, factor)


@pytest.fixture(scope="module")
def problems():
    """test_ba_sparse.py's fixture: (JAX dense, JAX sparse, port dense,
    port sparse)."""
    pd, _, _ = circle_grid_problem(noise_pnt=0.05, noise_rot=0.02)
    psj = jsp.from_dense(pd)
    ptd = interop.ba_problem_from_numpy(_np(pd), device="cpu")
    return pd, psj, ptd, _to_torch(psj)


def test_torch_from_dense_matches_jax(problems):
    _, psj, ptd, pst = problems
    pst2 = tsp.from_dense(ptd)
    for f in ("obs", "frame_idx", "obs_mask"):
        np.testing.assert_array_equal(getattr(pst2, f).numpy(),
                                      np.asarray(getattr(psj, f)))
    assert pst2.frame_idx.dtype == torch.int64
    _close(tsp.reproj_error(pst), jsp.reproj_error(psj))
    _close(tsp.reproj_error(pst), tp.reproj_error(ptd))


@pytest.mark.parametrize("pin", [(), (2,)], ids=["gauge", "pinned"])
def test_torch_sparse_blocks_match_jax(problems, pin):
    _, psj, ptd, pst = problems
    bj = _jblocks(psj, pin_frames=pin)
    bt = tsp.compute_blocks(pst, pin_frames=pin)
    for f in bj._fields:
        _close(getattr(bt, f), getattr(bj, f), **BLOCK_TOL)
    # and the dense port's blocks describe the same normal equations
    bd = td.compute_blocks(ptd, pin_frames=pin)
    for f in ("E", "G", "gp", "gf"):
        _close(getattr(bt, f), getattr(bd, f), **BLOCK_TOL)


@pytest.mark.parametrize("pin", [(), (2,)], ids=["gauge", "pinned"])
def test_torch_sparse_schur_matches_jax(problems, pin):
    """test_sparse_schur_matches_dense and
    test_sparse_pinned_frame_parity_with_dense on the port."""
    _, psj, ptd, pst = problems
    dXj, duj, okj = _jfull(
        psj, _jblocks(psj, pin_frames=pin), 1e-4, point_chunk=16,
        pin_frames=pin)
    dXt, dut, okt = tsp.solve_corrections_schur_sparse(
        pst, tsp.compute_blocks(pst, pin_frames=pin), 1e-4, point_chunk=16,
        pin_frames=pin)
    dXd, dud, okd = ts.solve_corrections_schur(
        td.compute_blocks(ptd, pin_frames=pin), 1e-4, pin_frames=pin)
    assert bool(okj) and bool(okt) and bool(okd)
    _close(dut, duj, **SOLVE_TOL)
    _close(dXt, dXj, **SOLVE_TOL)
    _close(dut, dud, **SOLVE_TOL)
    _close(dXt, dXd, **SOLVE_TOL)
    for p in pin:
        np.testing.assert_allclose(dut[p, 4:].numpy(), 0.0, atol=1e-14)


def test_torch_sparse_lm_iteration_decreases_error(problems):
    _, _, _, pst = problems
    err0 = float(tsp.reproj_error(pst))
    dX, du, ok = tsp.solve_corrections_schur_sparse(
        pst, tsp.compute_blocks(pst), 1e-4)
    assert bool(ok)
    assert float(tsp.reproj_error(tsp.apply_corrections(pst, dX, du))) < err0


@pytest.mark.parametrize("factor", [-1.0, -2.0])
def test_torch_sparse_failed_factorization_is_not_ok(problems, factor):
    """A damping factor <= -1 makes every point block indefinite: the
    batched 3x3 Cholesky fails. JAX reports NaN and ok=False; the port
    reports ok=False through the factorization's info, with no exception,
    in the full-width and the banded solver alike."""
    _, psj, _, pst = problems
    _, _, okj = _jfull(
        psj, _jblocks(psj), factor, point_chunk=16)
    _, _, okf = tsp.solve_corrections_schur_sparse(
        pst, tsp.compute_blocks(pst), factor, point_chunk=16)
    assert not bool(okj) and not bool(okf)
    pl = _to_torch(_local_track_problem(np.random.default_rng(5), Np=96, F=16,
                                        L=4))
    plan = tsp.plan_bands(pl.frame_idx.numpy(), pl.obs_mask.numpy(), 32, 16)
    assert plan is not None
    bl = tsp.compute_blocks(pl)
    assert not bool(tsp.solve_corrections_schur_banded(pl, bl, factor, plan)[2])
    assert bool(tsp.solve_corrections_schur_banded(pl, bl, 1e-4, plan)[2])


def _medium_problem(rng):
    """test_sparse_medium_scale_smoke's problem (800 points x 40 frames,
    track length 8, wrap-around tracks), the same draws in the same order."""
    from surikatoko_tpu.world import scene_gen
    Np, F, L = 800, 40, 8
    pts = rng.uniform(-2, 2, size=(Np, 3)) + np.array([0, 0, 4.0])
    K = np.array([[500.0, 0, 160.0], [0, 500.0, 120.0], [0, 0, 1.0]])
    angles = np.linspace(0, 2 * np.pi, F, endpoint=False)
    cfw = scene_gen.circle_camera_shots((0, 0, 4.0), 8.0, 2.0, angles)
    Rs, tvs = np.asarray(cfw.R), np.asarray(cfw.t)
    obs = np.zeros((Np, L, 2))
    fidx = np.zeros((Np, L), np.int32)
    mask = np.zeros((Np, L), bool)
    for i in range(Np):
        start = rng.integers(0, F)
        for l in range(L):
            f = (start + l) % F
            xc = Rs[f] @ pts[i] + tvs[f]
            if xc[2] < 0.5:
                continue
            ph = K @ xc
            obs[i, l] = ph[:2] / ph[2] + rng.normal(scale=0.3, size=2)
            fidx[i, l] = f
            mask[i, l] = True
    return jsp.BAProblemSparse(
        points=jnp.asarray(pts + rng.normal(scale=0.02, size=pts.shape)),
        cfw_R=jnp.asarray(Rs), cfw_t=jnp.asarray(tvs),
        K=jnp.broadcast_to(jnp.asarray(K), (F, 3, 3)),
        obs=jnp.asarray(obs), frame_idx=jnp.asarray(fidx),
        obs_mask=jnp.asarray(mask), f0=jnp.asarray(1.0))


def test_torch_sparse_medium_scale_matches_jax(rng):
    """test_sparse_medium_scale_smoke on the port: the first Gauss-Newton
    step equals JAX's, and three steps cut the error 20-fold."""
    psj = _medium_problem(rng)
    pst = _to_torch(psj)
    dXj, duj, _ = _jfull(
        psj, _jblocks(psj), 1e-4)
    err0 = float(tsp.reproj_error(pst))
    p = pst
    for it in range(3):
        dX, du, ok = tsp.solve_corrections_schur_sparse(
            p, tsp.compute_blocks(p), 1e-4)
        assert bool(ok)
        if it == 0:
            _close(du, duj, **SOLVE_TOL)
            _close(dX, dXj, **SOLVE_TOL)
        p2 = tsp.apply_corrections(p, dX, du)
        if float(tsp.reproj_error(p2)) < float(tsp.reproj_error(p)):
            p = p2
    assert float(tsp.reproj_error(p)) < err0 * 0.05


def test_torch_sparse_lm_matches_jax(problems):
    """test_ba_sparse.py::test_sparse_lm_driver: the port's
    SparseBundleAdjustment on the normalized problem takes JAX's path and
    converges."""
    _, psj, _, pst = problems
    pn = tn.normalize_scene(pst)[0]
    term = dict(allowed_reproj_err_rel_change=1e-10)
    jdrv = JSBA(point_chunk=16)
    pnj = jsp.BAProblemSparse(*(jnp.asarray(x.numpy()) for x in pn))
    okj, oj = jdrv.compute(pnj, JTC(**term))
    tdrv = TSBA(point_chunk=16)
    okt, ot = tdrv.compute(pn, TTC(**term))
    assert (okt, tdrv.stop_reason, tdrv.iterations, tdrv.trials) == \
           (okj, jdrv.stop_reason, jdrv.iterations, jdrv.trials)
    _close(tsp.reproj_error(ot), jsp.reproj_error(oj), rtol=1e-9, atol=1e-18)
    assert float(tsp.reproj_error(ot)) < 1e-4 * float(tsp.reproj_error(pn))


def _jax_bases(fidx, mask, plan, F):
    """The JAX package's per-chunk window starts (sparse.py:440-452),
    computed from the extended order as its traced loop does."""
    ext = np.asarray(plan.ext_idx)
    L = fidx.shape[1]
    fidx_s = np.concatenate([fidx, np.zeros((1, L), fidx.dtype)])[ext]
    mask_s = np.concatenate([mask, np.zeros((1, L), bool)])[ext]
    fmin_s = np.minimum(np.where(mask_s, fidx_s, F).min(axis=1), F - 1)
    return tuple(int(min(fmin_s[c * plan.point_chunk], F - plan.band_width))
                 for c in range(plan.n_banded_chunks))


def _plan_pair(fidx, mask, pc, F):
    pj = jsp.plan_bands(fidx, mask, point_chunk=pc, n_frames=F)
    pt = tsp.plan_bands(fidx, mask, pc, F)
    assert pj is not None and pt is not None
    np.testing.assert_array_equal(pt.ext_idx, np.asarray(pj.ext_idx))
    assert (pt.band_width, pt.n_banded_chunks, pt.overflow_chunk,
            pt.point_chunk) == (pj.band_width, pj.n_banded_chunks,
                                pj.overflow_chunk, pj.point_chunk)
    assert pt.bases == _jax_bases(fidx, mask, pj, F)
    return pj, pt


def _overflow_problem(rng):
    """test_banded_overflow_group_matches_full's problem: every 4th point
    also observed in the last frame (a wide, loop-closure-like span)."""
    ps = _local_track_problem(rng, Np=256, F=24, L=6)
    fidx = np.asarray(ps.frame_idx).copy()
    mask = np.asarray(ps.obs_mask).copy()
    obs = np.asarray(ps.obs).copy()
    K = np.asarray(ps.K[0])
    for i in range(0, 256, 4):
        R, t = np.asarray(ps.cfw_R[23]), np.asarray(ps.cfw_t[23])
        xc = R @ np.asarray(ps.points[i]) + t
        if xc[2] < 0.5:
            continue
        ph = K @ xc
        fidx[i, -1] = 23
        obs[i, -1] = ph[:2] / ph[2]
        mask[i, -1] = True
        fidx[i, 0] = 0
    return ps._replace(frame_idx=jnp.asarray(fidx), obs=jnp.asarray(obs),
                       obs_mask=jnp.asarray(mask))


BANDED_CASES = {
    # test_banded_schur_matches_full
    "local": (lambda rng: _local_track_problem(rng), 64, 64),
    # test_plan_bands_shrinks_degenerate_chunks
    "shrunk": (lambda rng: _local_track_problem(rng, Np=640, F=140, L=8), 640,
               256),
    # test_banded_overflow_group_matches_full
    "overflow": (_overflow_problem, 32, 32),
}


@pytest.mark.parametrize("case", list(BANDED_CASES))
def test_torch_banded_schur_matches_jax(rng, case):
    """The port's plan equals JAX's (ext_idx, band geometry, and the window
    starts JAX computes on the device per chunk); its banded solve equals
    the JAX banded solve and its own full-width solve."""
    build, pc_plan, pc_full = BANDED_CASES[case]
    psj = build(rng)
    F = psj.n_frames
    fidx, mask = np.asarray(psj.frame_idx), np.asarray(psj.obs_mask)
    pj, pt = _plan_pair(fidx, mask, pc_plan, F)
    assert pt.band_width < (0.8 * F if case == "shrunk" else F)
    if case == "shrunk":
        assert pt.point_chunk < pc_plan
    if case == "overflow":
        assert len(pt.ext_idx) > pt.n_banded_chunks * pt.point_chunk
    pst = _to_torch(psj)
    bt = tsp.compute_blocks(pst)
    dXb, dub, okb = tsp.solve_corrections_schur_banded(pst, bt, 1e-4, pt)
    dXf, duf, okf = tsp.solve_corrections_schur_sparse(
        pst, bt, 1e-4, point_chunk=pc_full)
    dXj, duj, okj = _jbanded(psj, _jblocks(psj), 1e-4, pj)
    assert bool(okj) and bool(okb) and bool(okf)
    _close(dub, duj, **SOLVE_TOL)
    _close(dXb, dXj, **SOLVE_TOL)
    _close(dub, duf, **SOLVE_TOL)
    _close(dXb, dXf, **SOLVE_TOL)


def test_torch_banded_plan_refuses_nonlocal_problems(rng):
    ps = _local_track_problem(rng, Np=64, F=24, L=6)
    fidx = np.asarray(ps.frame_idx).copy()
    mask = np.asarray(ps.obs_mask).copy()
    fidx[:, -1] = 23
    fidx[:, 0] = 0
    mask[:, -1] = True
    mask[:, 0] = True
    assert tsp.plan_bands(fidx, mask, 16, 24) is None
    assert jsp.plan_bands(fidx, mask, point_chunk=16, n_frames=24) is None


def test_torch_banded_with_unobserved_points_matches_full(rng):
    """Points with no observation sort first (first frame 0). The port
    starts the first chunk's window at frame 0, so its banded solve equals
    the full-width one; the JAX package starts it at F - W there and drops
    that chunk's observations before F - W (a reference fault)."""
    psj = _local_track_problem(rng, Np=256, F=24, L=6)
    fidx = np.asarray(psj.frame_idx).copy()
    mask = np.asarray(psj.obs_mask).copy()
    fidx[[5, 77, 130]] = 0
    mask[[5, 77, 130]] = False
    pst = _to_torch(psj._replace(frame_idx=jnp.asarray(fidx),
                                 obs_mask=jnp.asarray(mask)))
    pt = tsp.plan_bands(fidx, mask, 32, 24)
    assert pt is not None and pt.bases[0] == 0
    pj = jsp.plan_bands(fidx, mask, point_chunk=32, n_frames=24)
    assert _jax_bases(fidx, mask, pj, 24)[0] == 24 - pj.band_width
    bt = tsp.compute_blocks(pst)
    dXb, dub, okb = tsp.solve_corrections_schur_banded(pst, bt, 1e-4, pt)
    dXf, duf, okf = tsp.solve_corrections_schur_sparse(pst, bt, 1e-4,
                                                       point_chunk=32)
    assert bool(okb) and bool(okf)
    _close(dub, duf, **SOLVE_TOL)
    _close(dXb, dXf, **SOLVE_TOL)
    np.testing.assert_array_equal(dXb[[5, 77, 130]].numpy(), 0.0)


@pytest.mark.parametrize("device_loop", [False, True], ids=["host", "device"])
def test_torch_sparse_lm_banded_matches_unbanded_and_jax(rng, device_loop):
    """test_sparse_lm_driver_banded_matches_unbanded: band=True takes the
    band=False path, and the JAX banded one's. On the CPU the device loop
    is eager: it captures and replays no CUDA graph."""
    psj = _local_track_problem(rng, noise=0.05)
    pst = _to_torch(psj)
    term = dict(allowed_reproj_err_rel_change=1e-12, max_iters=10)
    graphs = {c: counts().get(c, 0) for c in GRAPH_COUNTERS}
    ba_f = TSBA(point_chunk=64, band=False, device_loop=device_loop)
    ok_f, p_f = ba_f.compute(pst, TTC(**term))
    ba_b = TSBA(point_chunk=64, band=True, device_loop=device_loop)
    ba_b.set_plan_inputs(np.asarray(psj.frame_idx), np.asarray(psj.obs_mask))
    ok_b, p_b = ba_b.compute(pst, TTC(**term))
    assert ba_b._plan is not None, "banding should be active here"
    assert {c: counts().get(c, 0) for c in GRAPH_COUNTERS} == graphs
    path = lambda d, ok: (ok, d.stop_reason, d.iterations, d.trials)  # noqa: E731
    assert path(ba_b, ok_b) == path(ba_f, ok_f)
    _close(tsp.reproj_error(p_b), tsp.reproj_error(p_f), rtol=1e-9, atol=1e-18)
    if device_loop:
        jdrv = JSBA(point_chunk=64, band=True, device_loop=True)
        okj, oj = jdrv.compute(psj, JTC(**term))
        assert path(ba_b, ok_b) == path(jdrv, okj)
        _close(tsp.reproj_error(p_b), jsp.reproj_error(oj), rtol=1e-9,
               atol=1e-18)


def test_torch_at_scale_problem_equals_jax_demo():
    """build_at_scale_problem at (600, 40, 6) equals the JAX demo's
    build_problem bit for bit, host arrays included."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))
    from demo_ba_at_scale import build_problem
    pj, fj, mj = build_problem(600, 40, 6, 0.5, 0, jnp.float64,
                               return_host_inputs=True)
    pt, ft, mt = ba_scene.build_at_scale_problem(600, 40, 6, noise_pix=0.5,
                                                 seed=0, device="cpu")
    for f in jsp.BAProblemSparse._fields:
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(mt, mj)
    assert pt.frame_idx.dtype == torch.int64 and pt.obs_mask.dtype == torch.bool
    # float32 on request, the same problem rounded
    p32 = ba_scene.build_at_scale_problem(600, 40, 6, noise_pix=0.5, seed=0,
                                          dtype=torch.float32, device="cpu")[0]
    assert p32.points.dtype == torch.float32
    np.testing.assert_array_equal(p32.obs.numpy(),
                                  np.asarray(pj.obs).astype(np.float32))
