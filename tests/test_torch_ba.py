"""Dense bundle adjustment of the PyTorch port against the JAX package, in
float64 on the CPU: the same numpy inputs (the circle-grid problems of
tests/test_ba.py and tests/test_lm_device.py) go through both.

Tolerances: Gauss-Newton blocks to rtol 1e-9; Schur and naive corrections
to rtol 1e-7 / atol 1e-10 (test_ba.py's own); LM runs take the identical
path, (ok, stop_reason, iterations, trials), with the final error to rtol
1e-9.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import so3 as jso3
from surikatoko_tpu.models.ba import BundleAdjustment as JBA
from surikatoko_tpu.models.ba import SparseBundleAdjustment as JSBA
from surikatoko_tpu.models.ba import TermCriteria as JTC
from surikatoko_tpu.models.ba import derivs as jd
from surikatoko_tpu.models.ba import lm_device as jlm
from surikatoko_tpu.models.ba import normalize as jn
from surikatoko_tpu.models.ba import problem as jp
from surikatoko_tpu.models.ba import schur as js
from surikatoko_tpu.models.ba import sparse as jsp
from surikatoko_tpu.world import scene_gen as jscene
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.geom import so3 as tso3
from surikatoko_tpu_torch.models.ba import BundleAdjustment as TBA
from surikatoko_tpu_torch.models.ba import SparseBundleAdjustment as TSBA
from surikatoko_tpu_torch.models.ba import TermCriteria as TTC
from surikatoko_tpu_torch.models.ba import derivs as td
from surikatoko_tpu_torch.models.ba import lm as tlm
from surikatoko_tpu_torch.models.ba import lm_device as tlmd
from surikatoko_tpu_torch.models.ba import normalize as tn
from surikatoko_tpu_torch.models.ba import problem as tp
from surikatoko_tpu_torch.models.ba import schur as ts
from surikatoko_tpu_torch.models.ba import sparse as tsp
from surikatoko_tpu_torch.world import scene_gen as tscene

from test_ba import circle_grid_problem

torch.set_num_threads(2)
BLOCK_TOL = dict(rtol=1e-9, atol=1e-12)
SOLVE_TOL = dict(rtol=1e-7, atol=1e-10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(**kw):
    pj = circle_grid_problem(**kw)[0]
    return pj, interop.ba_problem_from_numpy(_np(pj), device="cpu")


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               **(tol or dict(rtol=1e-12, atol=1e-12)))


def test_torch_so3_matches_jax(rng):
    w = np.concatenate([rng.normal(size=(8, 3)), 1e-7 * rng.normal(size=(4, 3)),
                        np.zeros((1, 3))])
    _close(tso3.skew(torch.as_tensor(w)), jso3.skew(jnp.asarray(w)))
    _close(tso3.exp(torch.as_tensor(w)), jso3.exp(jnp.asarray(w)))
    axis = rng.normal(size=(5, 3))
    ang = rng.normal(size=5)
    _close(tso3.rotmat_about_axis(torch.as_tensor(axis), torch.as_tensor(ang)),
           jso3.rotmat_about_axis(jnp.asarray(axis), jnp.asarray(ang)))
    _close(tso3.rotmat_about_axis(torch.as_tensor(axis[0]), 0.3),
           jso3.rotmat_about_axis(jnp.asarray(axis[0]), 0.3))
    # the BA linearization point: forward-mode derivative at w = 0 is the
    # generator basis, finite (the theta2_safe sanitizing)
    jac_t = torch.func.jacfwd(tso3.exp)(torch.zeros(3, dtype=torch.float64))
    jac_j = jax.jacfwd(jso3.exp)(jnp.zeros(3))
    assert bool(torch.isfinite(jac_t).all())
    _close(jac_t, jac_j)


def test_torch_circle_camera_shots_matches_jax():
    angles = np.linspace(np.pi / 2 - 0.6, np.pi / 2 + 0.6, 5)
    cj = jscene.circle_camera_shots((0.0, 0.0, 0.25), 4.0, 3.0, angles)
    ct = tscene.circle_camera_shots((0.0, 0.0, 0.25), 4.0, 3.0, angles)
    _close(ct.R, cj.R)
    _close(ct.t, cj.t)


def test_torch_normalization_matches_jax():
    pj, pt = _pair(noise_pnt=0.05, noise_rot=0.02)
    nj, sj = jn.normalize_scene(pj, t1y=2.0)
    nt, st = tn.normalize_scene(pt, t1y=2.0)
    for f in ("points", "cfw_R", "cfw_t"):
        _close(getattr(nt, f), getattr(nj, f))
    _close(st.world_scale, sj.world_scale)
    assert tn.check_world_is_normalized(nt, t1y=2.0)
    assert not tn.check_world_is_normalized(pt)
    assert tn.can_normalize(pt) and jn.can_normalize(pj)
    bt, bj = tn.revert_normalization(nt, st), jn.revert_normalization(nj, sj)
    for f in ("points", "cfw_R", "cfw_t"):
        _close(getattr(bt, f), getattr(bj, f))
        _close(getattr(bt, f), getattr(pt, f), rtol=0, atol=1e-9)
    # degenerate gauge: min_shift floors the scale on both sides
    pj0 = pj._replace(cfw_R=pj.cfw_R.at[1].set(pj.cfw_R[0]),
                      cfw_t=pj.cfw_t.at[1].set(pj.cfw_t[0]))
    pt0 = interop.ba_problem_from_numpy(_np(pj0), device="cpu")
    assert not tn.can_normalize(pt0) and not jn.can_normalize(pj0)
    _close(tn.normalize_scene(pt0, min_shift=1e-5)[1].world_scale,
           jn.normalize_scene(pj0, min_shift=1e-5)[1].world_scale)


@pytest.mark.parametrize("f0", [1.0, 600.0])
def test_torch_problem_error_terms_match_jax(f0):
    pj, pt = _pair(noise_pnt=0.02, f0=f0)
    _close(tp.residuals(pt), jp.residuals(pj))
    _close(tp.reproj_error(pt), jp.reproj_error(pj))
    assert int(tp.seen_points_count(pt)) == int(jp.seen_points_count(pj))
    _close(tp.reproj_error_pix_per_point(pt), jp.reproj_error_pix_per_point(pj))
    _close(tp.project_f0(pt.K[0], pt.cfw_R[0], pt.cfw_t[0], pt.points),
           jp.project_f0(pj.K[0], pj.cfw_R[0], pj.cfw_t[0], pj.points))
    # make_problem broadcasts a single K over the frames
    cfw = tscene.circle_camera_shots((0.0, 0.0, 0.25), 4.0, 3.0, [1.0, 2.0])
    p2 = tp.make_problem(np.zeros((3, 3)), cfw, np.eye(3), np.zeros((3, 2, 2)),
                         np.ones((3, 2), bool), f0)
    assert p2.K.shape == (2, 3, 3) and p2.obs_mask.dtype == torch.bool
    assert p2.f0.dtype == torch.float64 and float(p2.f0) == f0


def test_torch_f0_scaling_consistency():
    """test_ba.py::test_f0_scaling_consistency on the port: the same
    geometry at f0=1 and f0=600 gives errors that relate by f0^2."""
    e1 = float(tp.reproj_error(_pair(noise_pnt=0.02, f0=1.0)[1]))
    e600 = float(tp.reproj_error(_pair(noise_pnt=0.02, f0=600.0)[1]))
    np.testing.assert_allclose(e600 * 600.0 ** 2, e1, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(fix_gauge=False),
                                dict(pin_frames=(2,)),
                                dict(optimize_intrinsics=False, unity_comp_ind=0)],
                         ids=["gauge", "free", "pinned", "fixed_K"])
def test_torch_blocks_match_jax(kw):
    pj, pt = _pair(noise_pnt=0.05, noise_rot=0.02)
    bj = jd.compute_blocks(pj, **kw)
    bt = td.compute_blocks(pt, **kw)
    for f in bj._fields:
        _close(getattr(bt, f), getattr(bj, f), **BLOCK_TOL)
    mask_kw = {k: v for k, v in kw.items() if k != "fix_gauge"}
    np.testing.assert_array_equal(
        td.frame_var_mask(pt.n_frames, **mask_kw, device="cpu").numpy(),
        np.asarray(jd.frame_var_mask(pj.n_frames, **mask_kw)))


def test_torch_gradient_vs_autograd():
    """test_ba.py::test_gauss_newton_gradient_vs_autodiff on the port: the
    block gradient (gp, gf) equals d(0.5*err)/d(vars) by reverse mode."""
    _, pt = _pair(noise_pnt=0.05, noise_rot=0.02)
    blocks = td.compute_blocks(pt, fix_gauge=False)
    pts = pt.points.clone().requires_grad_(True)
    (0.5 * tp.reproj_error(pt._replace(points=pts))).backward()
    _close(blocks.gp, pts.grad, rtol=1e-7, atol=1e-10)
    u = torch.zeros(pt.n_frames, 10, dtype=torch.float64, requires_grad=True)
    (0.5 * tp.reproj_error(td.apply_corrections(
        pt, torch.zeros_like(pt.points), u))).backward()
    _close(blocks.gf, u.grad, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("factor", [1e-4, 1.0, 100.0])
def test_torch_schur_and_naive_match_jax(factor):
    pj, pt = _pair(noise_pnt=0.05, noise_rot=0.02)
    bj, bt = jd.compute_blocks(pj), td.compute_blocks(pt)
    dXj, duj, okj = js.solve_corrections_schur(bj, factor)
    dXt, dut, okt = ts.solve_corrections_schur(bt, factor)
    dXn, dun, okn = ts.solve_corrections_naive(bt, factor)
    assert bool(okj) and bool(okt) and bool(okn)
    _close(dut, duj, **SOLVE_TOL)
    _close(dXt, dXj, **SOLVE_TOL)
    _close(dun, dut, rtol=1e-6, atol=1e-9)
    _close(dXn, dXt, rtol=1e-6, atol=1e-9)
    sj = js.solve_corrections_steepest_descent(bj, 0.1)
    st = ts.solve_corrections_steepest_descent(bt, 0.1)
    _close(st[0], sj[0], **BLOCK_TOL)
    _close(st[1], sj[1], **BLOCK_TOL)


def test_torch_gauge_fixed_vars_get_zero_corrections():
    _, pt = _pair(noise_pnt=0.05, noise_rot=0.02)
    _, du, _ = ts.solve_corrections_schur(td.compute_blocks(pt), 1e-4)
    np.testing.assert_allclose(du[0, 4:].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(float(du[1, 5]), 0.0, atol=1e-12)


@pytest.mark.parametrize("factor", [-1.0, -2.0])
def test_torch_failed_factorization_is_not_ok(factor):
    """A damping factor <= -1 makes the reduced system indefinite: the
    Cholesky fails. JAX reports it as NaN and ok=False; the port as ok=False
    through the factorization's info, without an exception."""
    pj, pt = _pair(noise_pnt=0.05, noise_rot=0.02)
    _, _, okj = js.solve_corrections_schur(jd.compute_blocks(pj), factor)
    _, _, okt = ts.solve_corrections_schur(td.compute_blocks(pt), factor)
    assert not bool(okj) and not bool(okt)
    # the reduced system's factorization info, folded into ok on the device
    bt = td.compute_blocks(pt)
    S = -torch.ones(20, 20, dtype=torch.float64)
    _, info = ts.preconditioned_cholesky_solve(S, torch.ones(20, dtype=torch.float64))
    assert int(info) != 0
    assert bool(ts.solve_corrections_schur(bt, 1e-4)[2])


# ---- LM runs: the circle-grid cases of test_ba.py and test_lm_device.py

LM_CASES = {
    "point_noise": (dict(noise_pnt=0.03), dict(allowed_reproj_err_rel_change=1e-12)),
    "rotation_noise": (dict(noise_pnt=0.01, noise_rot=0.01),
                       dict(allowed_reproj_err_rel_change=1e-12)),
    "exact": (dict(), dict(allowed_reproj_err_rel_change=1e-10)),
    "default_criteria": (dict(noise_pnt=0.05, noise_rot=0.01),
                         dict(allowed_reproj_err_rel_change=1e-14, max_iters=30)),
    "max_iters": (dict(noise_pnt=0.05, noise_rot=0.01),
                  dict(allowed_reproj_err_rel_change=1e-18, max_iters=3)),
    "reduces_error": (dict(noise_pnt=0.1, noise_rot=0.02),
                      dict(allowed_reproj_err_rel_change=1e-12)),
}


@pytest.fixture(scope="module")
def jax_bas():
    """One JAX BundleAdjustment per form, shared so their compiled programs
    are."""
    return {False: JBA(), True: JBA(device_loop=True)}


def _same_path(jdrv, tdrv, okj, okt):
    assert (okt, tdrv.stop_reason, tdrv.iterations, tdrv.trials) == \
           (okj, jdrv.stop_reason, jdrv.iterations, jdrv.trials)


@pytest.mark.parametrize("device_loop", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("case", list(LM_CASES))
def test_torch_lm_dense_matches_jax(jax_bas, case, device_loop):
    prob_kw, term_kw = LM_CASES[case]
    pj, pt = _pair(**prob_kw)
    jdrv, tdrv = jax_bas[device_loop], TBA(device_loop=device_loop)
    okj, oj = jdrv.compute_inplace(pj, JTC(**term_kw))
    okt, ot = tdrv.compute_inplace(pt, TTC(**term_kw))
    if case == "exact":
        # the error is rounding noise (~1e-28) here, so each accept/reject
        # compares noise: only test_ba.py's own bound holds for both
        assert float(tp.reproj_error(ot)) < 1e-10
        assert float(jp.reproj_error(oj)) < 1e-10
        return
    _same_path(jdrv, tdrv, okj, okt)
    _close(tp.reproj_error(ot), jp.reproj_error(oj), rtol=1e-9, atol=1e-18)
    _close(ot.points, oj.points, rtol=1e-6, atol=1e-9)
    if case == "reduces_error":
        assert okt and float(tp.reproj_error(ot)) < 1e-6 * float(
            tp.reproj_error(pt))


@pytest.mark.parametrize("inplace", [False, True], ids=["compute", "inplace"])
def test_torch_lm_sparse_device_loop_matches_host_and_jax(inplace):
    """test_lm_device.py's sparse cases: the port's device loop, its host
    loop and the JAX device loop take one path, and the inplace form lands
    in the original gauge."""
    pj, _ = _pair(noise_pnt=0.05, noise_rot=0.01 if inplace else 0.0)
    psj = jsp.from_dense(pj)
    pst = interop.sparse_problem_from_numpy(_np(psj), device="cpu")
    term = dict(allowed_reproj_err_rel_change=1e-14, max_iters=25)
    run = "compute_inplace" if inplace else "compute"
    jdrv = JSBA(point_chunk=32, device_loop=True)
    okj, oj = getattr(jdrv, run)(psj, JTC(**term))
    outs = []
    for dl in (False, True):
        tdrv = TSBA(point_chunk=32, device_loop=dl)
        okt, ot = getattr(tdrv, run)(pst, TTC(**term))
        _same_path(jdrv, tdrv, okj, okt)
        _close(tsp.reproj_error(ot), jsp.reproj_error(oj), rtol=1e-9,
               atol=1e-18)
        outs.append(ot)
    for f in ("points", "cfw_t"):
        _close(getattr(outs[1], f), getattr(outs[0], f), rtol=1e-6, atol=1e-9)
        _close(getattr(outs[1], f), getattr(oj, f), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("device_loop", [False, True], ids=["host", "device"])
def test_torch_cannot_normalize_matches_jax(jax_bas, device_loop):
    """Zero cam0-cam1 shift: both packages refuse with the same reason and
    hand the problem back untouched (dense and sparse BA)."""
    pj, _ = _pair(noise_pnt=0.05)
    pj = pj._replace(cfw_R=pj.cfw_R.at[1].set(pj.cfw_R[0]),
                     cfw_t=pj.cfw_t.at[1].set(pj.cfw_t[0]))
    pt = interop.ba_problem_from_numpy(_np(pj), device="cpu")
    term = dict(allowed_reproj_err_rel_change=1e-14, max_iters=5)
    jdrv, tdrv = jax_bas[device_loop], TBA(device_loop=device_loop)
    okj, _ = jdrv.compute_inplace(pj, JTC(**term))
    okt, ot = tdrv.compute_inplace(pt, TTC(**term))
    assert not okj and not okt
    assert tdrv.stop_reason == jdrv.stop_reason == \
        "cannot normalize (zero cam0-cam1 shift)"
    assert torch.equal(ot.points, pt.points) and torch.equal(ot.cfw_t, pt.cfw_t)
    sdrv = TSBA(point_chunk=32, device_loop=device_loop)
    oks, os_ = sdrv.compute_inplace(tsp.from_dense(pt), TTC(**term))
    assert not oks and sdrv.stop_reason == tdrv.stop_reason
    assert torch.equal(os_.points, pt.points)


def test_torch_failed_factorization_damps_up_like_jax():
    """A solver whose factorization fails for factor <= 1e-3 (the damped
    system is indefinite there): every such trial is ok=False and the LM
    damps up. The port's device loop, its host loop and the JAX program
    take the same path, with the failed trials counted."""
    pj, pt = _pair(noise_pnt=0.05, noise_rot=0.01)
    pj = jn.normalize_scene(pj)[0]
    pt = tn.normalize_scene(pt)[0]
    kw = dict(err_thresh=1e-14, max_factor=1e12, max_iters=6)
    res_j = jax.jit(lambda p: jlm.run_lm_on_device(
        p, blocks_fn=jd.compute_blocks,
        solve_fn=lambda _p, b, f: js.solve_corrections_schur(
            b, jnp.where(f > 1e-3, f, -2.0)),
        apply_fn=jd.apply_corrections, err_fn=jp.reproj_error, **kw))(pj)
    t_solve = lambda _p, b, f: ts.solve_corrections_schur(  # noqa: E731
        b, f if f > 1e-3 else -2.0)
    res_t = tlmd.run_lm_on_device(
        pt, blocks_fn=td.compute_blocks, solve_fn=t_solve,
        apply_fn=td.apply_corrections, err_fn=tp.reproj_error, **kw)
    code, iters, trials = int(res_j[1]), int(res_j[2]), int(res_j[4])
    assert (res_t[1], res_t[2], res_t[4]) == (code, iters, trials)
    assert trials > iters + 1          # failed trials were counted
    _close(res_t[3], res_j[3], rtol=1e-9, atol=1e-18)
    host = SimpleNamespace()
    ok_h, p_h = tlm._host_loop(
        host, pt, TTC(allowed_reproj_err_rel_change=1e-14, max_iters=6),
        td.compute_blocks, t_solve, td.apply_corrections, tp.reproj_error)
    assert (host.stop_reason, host.iterations, host.trials) == (
        tlmd.STOP_REASON_STR[code], iters, trials)
    _close(tp.reproj_error(p_h), res_t[3], rtol=1e-12, atol=1e-18)
