"""The dino file-format path of the PyTorch port against the JAX package, in
float64 on the CPU: the committed VGG-format fixture of
tests/test_io_fixtures.py, the synthetic turntable written in the same
formats, and chip_smoke.py's ba_dino phase at 300 points.

Tolerances: parsed files equal; decomposed cameras to rtol 1e-12 and the
assembled problems to rtol 1e-10 (triangulation solves 3x3 normal
equations, float64 on both sides); LM runs take the identical path, (ok, stop_reason, iterations,
trials), with the final error to rtol 1e-9. The synthetic scene equals the
JAX one bit for bit, and so do the files written from it.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import triangulate as jtri
from surikatoko_tpu.geom.align import aligned_rmse as j_aligned_rmse
from surikatoko_tpu.io import dino as jdino
from surikatoko_tpu.io import mat_io as jmat
from surikatoko_tpu.models.ba import BundleAdjustment as JBA
from surikatoko_tpu.models.ba import SparseBundleAdjustment as JSBA
from surikatoko_tpu.models.ba import TermCriteria as JTC
from surikatoko_tpu.models.ba import problem as jp
from surikatoko_tpu.models.ba import sparse as jsp
from surikatoko_tpu_torch.geom import triangulate as ttri
from surikatoko_tpu_torch.io import dino as tdino
from surikatoko_tpu_torch.io import mat_io as tmat
from surikatoko_tpu_torch.models.ba import BundleAdjustment as TBA
from surikatoko_tpu_torch.models.ba import SparseBundleAdjustment as TSBA
from surikatoko_tpu_torch.models.ba import TermCriteria as TTC
from surikatoko_tpu_torch.models.ba import problem as tp
from surikatoko_tpu_torch.models.ba import sparse as tsp

torch.set_num_threads(2)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
DINO_DIR = os.path.join(FIXTURES, "oxfvisgeom", "dinosaur")
PARSE_TOL = dict(rtol=1e-12, atol=1e-12)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               **(tol or PARSE_TOL))


def _path(drv, ok):
    return ok, drv.stop_reason, drv.iterations, drv.trials


def _same_problem(pt, pj, tol=PARSE_TOL):
    for f in pj._fields:
        a, b = getattr(pt, f), getattr(pj, f)
        if a.is_floating_point():
            _close(a, b, **tol)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_torch_mat_io_matches_jax(tmp_path):
    for name in ("dinoPs_as_mat108x4.txt", "viff.xy"):
        path = os.path.join(DINO_DIR, name)
        np.testing.assert_array_equal(tmat.read_matrix_from_file(path),
                                      jmat.read_matrix_from_file(path))
    m = np.random.default_rng(0).normal(size=(4, 3))
    tmat.write_matrix_to_file(tmp_path / "t.txt", m)
    jmat.write_matrix_to_file(tmp_path / "j.txt", m)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(tmat.read_matrix_from_file(tmp_path / "t.txt"), m)
    (tmp_path / "ragged.txt").write_text("1 2 3\n4 5\n")
    with pytest.raises(ValueError):
        tmat.read_matrix_from_file(tmp_path / "ragged.txt")


def test_torch_decompose_and_triangulate_match_jax():
    """decompose_proj_mat on the fixture's P-matrices, then the batched and
    the single-point triangulation of its tracks."""
    Ps = jmat.read_matrix_from_file(
        os.path.join(DINO_DIR, "dinoPs_as_mat108x4.txt")).reshape(-1, 3, 4)
    Ks, Rs, ts = [], [], []
    for P in Ps:
        sj, Kj, wj = jtri.decompose_proj_mat(jnp.asarray(P))
        st, Kt, wt = ttri.decompose_proj_mat(torch.as_tensor(P))
        _close(st, sj)
        _close(Kt, Kj)
        _close(wt.R, wj.R)
        _close(wt.t, wj.t, rtol=1e-12, atol=1e-9)
        cfw = wt.inv()
        Ks.append(Kt.numpy())
        Rs.append(cfw.R.numpy())
        ts.append(cfw.t.numpy())
    P_re = np.stack([K @ np.concatenate([R, t[:, None]], 1)
                     for K, R, t in zip(Ks, Rs, ts)])
    viff = jmat.read_matrix_from_file(os.path.join(DINO_DIR, "viff.xy"))
    obs = viff.reshape(-1, len(Ps), 2)
    mask = ~np.any(obs == -1, axis=-1)
    Xt = ttri.triangulate_points_batch(torch.as_tensor(P_re), torch.as_tensor(obs),
                                       1.0, torch.as_tensor(mask))
    Xj = jtri.triangulate_points_batch(jnp.asarray(P_re), jnp.asarray(obs), 1.0,
                                       jnp.asarray(mask))
    _close(Xt, Xj, rtol=1e-10, atol=1e-10)
    X1 = ttri.triangulate_point_least_squares(
        torch.as_tensor(P_re), torch.as_tensor(obs[3]), 1.0,
        torch.as_tensor(mask[3]))
    _close(X1, Xt[3], rtol=1e-12, atol=1e-12)


def test_torch_load_dino_fixture_matches_jax():
    """test_load_dino_problem_from_fixture on the port: the same problem as
    JAX's loader, noiseless (error ~0), intrinsics recovered."""
    pj = jdino.load_dino_problem(FIXTURES, f0=600.0)
    pt = tdino.load_dino_problem(FIXTURES, f0=600.0)
    _same_problem(pt, pj, dict(rtol=1e-10, atol=1e-12))
    assert pt.n_frames == 6 and pt.n_points == 20
    assert int(pt.obs_mask.sum()) == 20 * 6 - 18 * 2
    pix = float(tp.reproj_error_pix_per_point(pt))
    assert pix < 1e-6, pix
    np.testing.assert_allclose(float(pt.K[0, 0, 0]), 3217.3 / 600.0, rtol=1e-9)
    np.testing.assert_allclose(float(pt.K[0, 1, 1]), 3217.3 / 600.0, rtol=1e-9)
    assert float(pt.K[0, 0, 1]) == 0.0
    p32 = tdino.load_dino_problem(FIXTURES, f0=600.0, max_points=7,
                                  dtype=torch.float32)
    assert p32.points.dtype == torch.float32 and p32.n_points == 7
    assert p32.obs_mask.dtype == torch.bool


@pytest.fixture(scope="module")
def fixture_noise():
    p = jdino.load_dino_problem(FIXTURES, f0=600.0)
    return np.random.default_rng(0).normal(scale=0.01, size=p.points.shape)


def test_torch_dino_fixture_ba_matches_jax(fixture_noise):
    """test_dino_fixture_ba_converges: the perturbed fixture, dense LM, both
    packages on one path; the error falls a million-fold."""
    term = dict(allowed_reproj_err_rel_change=1e-14)
    pj = jdino.load_dino_problem(FIXTURES, f0=600.0)
    pj = pj._replace(points=pj.points + jnp.asarray(fixture_noise))
    pt = tdino.load_dino_problem(FIXTURES, f0=600.0)
    pt = pt._replace(points=pt.points + torch.as_tensor(fixture_noise))
    jdrv, tdrv = JBA(), TBA()
    okj, oj = jdrv.compute_inplace(pj, JTC(**term))
    okt, ot = tdrv.compute_inplace(pt, TTC(**term))
    assert _path(tdrv, okt) == _path(jdrv, okj)
    err0, err1 = float(tp.reproj_error(pt)), float(tp.reproj_error(ot))
    assert err1 < 1e-6 * err0, (err0, err1)
    _close(ot.points, oj.points, rtol=1e-6, atol=1e-9)


def test_torch_load_dino_sparse_matches_dense_and_jax(fixture_noise):
    """test_load_dino_problem_sparse_matches_dense on the port: the sparse
    assembly is the dense problem track-major, equals JAX's, and its LM
    lands on the dense LM's solution on JAX's path."""
    pd = tdino.load_dino_problem(FIXTURES, f0=600.0)
    ps, fidx, tmask = tdino.load_dino_problem_sparse(FIXTURES, f0=600.0)
    psj, fidx_j, tmask_j = jdino.load_dino_problem_sparse(FIXTURES, f0=600.0)
    np.testing.assert_array_equal(fidx, fidx_j)
    np.testing.assert_array_equal(tmask, tmask_j)
    _same_problem(ps, psj, dict(rtol=1e-10, atol=1e-12))
    assert ps.n_points == pd.n_points
    assert int(tmask.sum()) == int(pd.obs_mask.sum())
    _close(tsp.reproj_error(ps), tp.reproj_error(pd), rtol=1e-12, atol=1e-24)

    dp = torch.as_tensor(fixture_noise)
    term = dict(allowed_reproj_err_rel_change=1e-14)
    ok_d, pd_opt = TBA().compute_inplace(pd._replace(points=pd.points + dp),
                                         TTC(**term))
    ba_s = TSBA(point_chunk=32, band=False)
    ba_s.set_plan_inputs(fidx, tmask)
    ok_s, ps_opt = ba_s.compute_inplace(ps._replace(points=ps.points + dp),
                                        TTC(**term))
    assert ok_d and ok_s
    assert float(tsp.reproj_error(ps_opt)) < 1e-6
    _close(ps_opt.points, pd_opt.points, rtol=0, atol=1e-6)
    jdrv = JSBA(point_chunk=32, band=False)
    jdrv.set_plan_inputs(fidx_j, tmask_j)
    okj, oj = jdrv.compute_inplace(
        psj._replace(points=psj.points + jnp.asarray(fixture_noise)),
        JTC(**term))
    assert _path(ba_s, ok_s) == _path(jdrv, okj)
    _close(ps_opt.points, oj.points, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kw", [dict(n_frames=8, n_points=48, vary_track_len=True,
                                     seed=3),
                                dict(n_frames=36, n_points=300,
                                     vary_track_len=True),
                                dict(n_frames=12, n_points=60, visibility=0.5,
                                     seed=1)],
                         ids=["fixture_size", "dino_300", "fixed_arc"])
def test_torch_synthetic_dino_round_trip_matches_jax(tmp_path, kw):
    """test_fullscale_synthetic_roundtrip on the port: the raw scene equals
    JAX's bit for bit; the files the port writes equal JAX's byte for byte;
    reading them back gives JAX's problem and GT."""
    raw_t = tdino.synthetic_dino_raw(**kw)
    raw_j = jdino.synthetic_dino_raw(**kw)
    for a, b in zip(raw_t, raw_j):
        np.testing.assert_array_equal(a, b)
    Ps, obs, mask, gt = raw_t
    keep = mask.sum(axis=1) >= 2
    dt = tdino.write_dino_files(str(tmp_path / "t"), Ps, obs[keep], mask[keep],
                                gt_points=gt[keep])
    dj = jdino.write_dino_files(str(tmp_path / "j"), Ps, obs[keep], mask[keep],
                                gt_points=gt[keep])
    for name in sorted(os.listdir(dj)):
        with open(os.path.join(dt, name), "rb") as ft, \
                open(os.path.join(dj, name), "rb") as fj:
            assert ft.read() == fj.read(), name
    with open(os.path.join(dt, "viff.xy")) as f:
        assert "-1.000000" in f.read()

    pt = tdino.load_dino_problem(str(tmp_path / "t"), f0=600.0)
    pj = jdino.load_dino_problem(str(tmp_path / "j"), f0=600.0)
    assert pt.n_frames == kw["n_frames"] and pt.n_points == int(keep.sum())
    np.testing.assert_array_equal(pt.obs_mask.numpy(), mask[keep])
    np.testing.assert_allclose(pt.obs.numpy()[mask[keep]], obs[keep][mask[keep]],
                               atol=2e-6)
    _same_problem(pt, pj, dict(rtol=1e-10, atol=1e-10))
    gt_t = tdino.load_gt_points(str(tmp_path / "t"))
    np.testing.assert_array_equal(gt_t, jdino.load_gt_points(str(tmp_path / "j")))
    np.testing.assert_allclose(gt_t, gt[keep], rtol=1e-9)
    assert tdino.load_gt_points(FIXTURES) is None


def test_torch_synthetic_dino_problem_matches_jax():
    pt, gt_t = tdino.synthetic_dino_problem(n_frames=12, n_points=80, seed=2)
    pj, gt_j = jdino.synthetic_dino_problem(n_frames=12, n_points=80, seed=2)
    np.testing.assert_array_equal(gt_t, gt_j)
    _same_problem(pt, pj, dict(rtol=1e-10, atol=1e-10))
    _close(tp.reproj_error(pt), jp.reproj_error(pj), rtol=1e-10, atol=1e-18)


def test_torch_ba_dino_phase_matches_jax():
    """chip_smoke.py's ba_dino phase at 300 points, in float64 on the CPU,
    against the JAX bench's dino section (bench.py:587-623) on the same
    files: the warm, the timed and the converging device-loop LM each take
    JAX's path, and the map ATE against GT agrees."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    got = chip_smoke.run_dino("cpu", torch.float64, n_points=300)
    assert got["finite"] and got["err_final"] < got["err_initial"]

    import tempfile
    Ps, obs, mask, gt = jdino.synthetic_dino_raw(36, 300, vary_track_len=True)
    keep = mask.sum(axis=1) >= 2
    assert (got["frames"], got["points"]) == (36, int(keep.sum()))
    with tempfile.TemporaryDirectory() as td:
        jdino.write_dino_files(td, Ps, obs[keep], mask[keep], gt_points=gt[keep])
        p, fidx, tmask = jdino.load_dino_problem_sparse(td, f0=600.0)
        gt_pts = jdino.load_gt_points(td)
    ba = JSBA(device_loop=True, band=False, point_chunk=1024)
    ba.set_plan_inputs(fidx, tmask)
    term = JTC(allowed_reproj_err_rel_change=None, max_iters=8)
    ok_w, p_w = ba.compute_inplace(p, term)
    assert (got["warm"]["ok"], got["warm"]["stop"], got["warm"]["iters"],
            got["warm"]["trials"]) == _path(ba, ok_w)
    ok_t, _ = ba.compute_inplace(p._replace(points=p.points * (1.0 + 1e-6)),
                                 term)
    assert (got["timed"]["ok"], got["timed"]["stop"], got["timed"]["iters"],
            got["timed"]["trials"]) == _path(ba, ok_t)
    ok_c, p_c = ba.compute_inplace(p_w, JTC(allowed_reproj_err_rel_change=4.56e-8,
                                            max_iters=40))
    assert (got["converge"]["ok"], got["converge"]["stop"],
            got["converge"]["iters"], got["converge"]["trials"]) == _path(ba, ok_c)
    np.testing.assert_allclose(got["err_initial"], float(jsp.reproj_error(p)),
                               rtol=1e-12)
    np.testing.assert_allclose(got["err_final"], float(jsp.reproj_error(p_c)),
                               rtol=1e-9)
    ate_j = float(j_aligned_rmse(p_c.points, jnp.asarray(gt_pts)))
    np.testing.assert_allclose(got["map_ate"], ate_j, rtol=1e-6)
