"""Batched evaluation in the PyTorch port against the JAX package, in float64
on the CPU (float32 where the Pallas kernel is the reference):

- kernel B2's plain version with a leading batch axis against the Pallas
  kernel vmapped in interpret mode (f32, atol 2e-5, the pin of
  test_torch_covariance.py), a per-problem keep against numpy (1e-12), each
  slice bit for bit the unbatched plain version, and the dispatcher's
  operator under ``torch.func.vmap`` equal to the batched plain version;
- ``make_batched_scan_runner`` on tests/test_batch_eval.py's inputs (6 noise
  keys, capacity 16, frames 1-20, the draws JAX makes from each key handed
  in) against ``jax.vmap`` of the JAX runner at 1e-8 and against its own
  unbatched runs at 1e-12, for impls 1-4;
- ``run_lm_on_device_batched`` on test_device_loop_vmaps_batch_ba's three
  problems against ``jax.jit(jax.vmap(run_one))``: stop codes, iterations
  and trials equal, the final error at rtol 1e-9 (atol 1e-18: it ends at the
  rounding floor, ~1e-24), points and poses at 1e-8; and each problem against
  its own unbatched port run;
- ``BundleAdjustment.compute_batched`` with a degenerate gauge in the batch: that
  problem comes back untouched, the others as alone;
- the runners: ``demos.batch_ba`` at ``--batch 4``, the circle-grid fixture
  and ``world/test_data_builder`` against the JAX ones (1e-12).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.models.ba import derivs as jd
from surikatoko_tpu.models.ba import lm_device as jlm
from surikatoko_tpu.models.ba import problem as jp
from surikatoko_tpu.models.ba import schur as js
from surikatoko_tpu.models.monoslam import init_state as j_init_state
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.ops.covariance import symmetric_downdate as j_downdate
from surikatoko_tpu.world import device_runner as jdr
from surikatoko_tpu.world import test_data_builder as jtdb
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.demos import batch_ba
from surikatoko_tpu_torch.models.ba import BundleAdjustment, TermCriteria
from surikatoko_tpu_torch.models.ba import derivs as td
from surikatoko_tpu_torch.models.ba import lm_device as tlmd
from surikatoko_tpu_torch.models.ba import problem as tp
from surikatoko_tpu_torch.models.ba import schur as ts
from surikatoko_tpu_torch.ops import covariance
from surikatoko_tpu_torch.utils.profiling import counts
from surikatoko_tpu_torch.world import ba_scene
from surikatoko_tpu_torch.world import device_runner as tdr
from surikatoko_tpu_torch.world import test_data_builder as ttdb
from test_ba import circle_grid_problem as j_circle_grid_problem
from test_device_runner import build_device_scenario

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _downdate_case(rng, B, D, m, dtype):
    A = rng.normal(size=(B, D, D)) * 0.1
    P = A @ A.transpose(0, 2, 1)
    M = rng.normal(size=(B, m, D)) * 0.05
    keep = (rng.uniform(size=(B, D)) > 0.1).astype(np.float64)
    return P.astype(dtype), M.astype(dtype), keep.astype(dtype)


@pytest.mark.parametrize("B,D,m", [(3, 109, 32), (2, 300, 64)])
def test_torch_batched_plain_downdate_matches_vmapped_pallas(B, D, m):
    P, M, _ = _downdate_case(np.random.default_rng(D), B, D, m, np.float32)
    want = np.asarray(jax.vmap(functools.partial(j_downdate, interpret=True))(
        jnp.asarray(P), jnp.asarray(M)))
    got = covariance.symmetric_downdate_ref(torch.as_tensor(P),
                                            torch.as_tensor(M))
    assert got.shape == (B, D, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert torch.equal(got, got.mT)
    for b in range(B):
        assert torch.equal(got[b], covariance.symmetric_downdate_ref(
            torch.as_tensor(P[b]), torch.as_tensor(M[b])))


def test_torch_batched_downdate_keep_matches_numpy_f64():
    """A per-problem keep: P_b o k_b k_b^T - (M_b o k_b)^T (M_b o k_b), each
    slice equal to the unbatched plain version, and a shared keep ([D]) and
    M ([m,D]) broadcast over the batch."""
    B, D, m = 3, 130, 7
    P, M, keep = _downdate_case(np.random.default_rng(1), B, D, m, np.float64)
    Pt, Mt, kt = (torch.as_tensor(a) for a in (P, M, keep))
    got = covariance.symmetric_downdate(Pt, Mt, kt)
    for b in range(B):
        Mk = M[b] * keep[b][None, :]
        want = P[b] * np.outer(keep[b], keep[b]) - Mk.T @ Mk
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-12)
        assert torch.equal(got[b], covariance.symmetric_downdate_ref(
            Pt[b], Mt[b], kt[b]))
    assert torch.equal(got, got.mT)
    shared = covariance.symmetric_downdate(Pt, Mt[0], kt[0])
    for b in range(B):
        assert torch.equal(shared[b], covariance.symmetric_downdate_ref(
            Pt[b], Mt[0], kt[0]))


def test_torch_downdate_operator_under_vmap_equals_batched_plain():
    """``symmetric_downdate`` under ``torch.func.vmap`` goes through the
    dispatcher's operator and its vmap rule, batched and unbatched
    arguments alike, nested too, and counts no launch on the CPU."""
    B, D, m = 4, 109, 32
    P, M, keep = (torch.as_tensor(a) for a in _downdate_case(
        np.random.default_rng(2), B, D, m, np.float64))
    want = covariance.symmetric_downdate_ref(P, M, keep)
    before = counts().get("b2.calls", 0)
    vmap = torch.func.vmap
    assert torch.equal(vmap(covariance.symmetric_downdate)(P, M, keep), want)
    assert torch.equal(vmap(covariance.symmetric_downdate,
                            in_dims=(0, 0, None))(P, M, None),
                       covariance.symmetric_downdate_ref(P, M))
    got = vmap(covariance.symmetric_downdate, in_dims=(None, 0, None))(
        P[0], M, keep[0])
    assert torch.equal(got, covariance.symmetric_downdate_ref(
        P[0].expand(B, D, D), M, keep[0].expand(B, D)))
    nested = vmap(vmap(covariance.symmetric_downdate))(
        P.reshape(2, 2, D, D), M.reshape(2, 2, m, D), keep.reshape(2, 2, D))
    assert torch.equal(nested.reshape(B, D, D), want)
    assert counts().get("b2.calls", 0) == before
    op = torch.ops.surikatoko.symmetric_downdate
    assert torch.equal(op(P, M, keep), want)


def test_torch_unbatched_downdate_takes_no_dispatcher_hop(monkeypatch):
    """A call with no batched argument goes straight to the kernel (here
    the plain version), not through the dispatcher's operator; under vmap
    the operator is taken."""
    P, M, keep = (torch.as_tensor(a) for a in _downdate_case(
        np.random.default_rng(3), 2, 43, 10, np.float64))
    calls = []
    op = covariance._downdate_op
    monkeypatch.setattr(covariance, "_downdate_op",
                        lambda *a: calls.append(1) or op(*a))
    covariance.symmetric_downdate(P[0], M[0], keep[0])
    covariance.symmetric_downdate(P, M, keep)
    assert calls == []
    torch.func.vmap(covariance.symmetric_downdate)(P, M, keep)
    # the wrapper's call, then the vmap rule's on the unwrapped batch
    assert calls == [1, 1]


@pytest.fixture(scope="module")
def world16():
    """tests/test_batch_eval.py's world: capacity 16, the bootstrap from
    PRNGKey(0)."""
    dtype = jnp.float64
    sc = build_device_scenario(capacity=16, dtype=dtype)
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                               (0.01, 0.01), dtype=dtype)
    params = j_make_params(cam, None, dt=1.0,
                           process_noise_lin_veloc_std=0.075,
                           process_noise_ang_veloc_std=0.01, dtype=dtype)
    state = jdr.init_with_gt_landmarks(params, sc, j_init_state(16, dtype=dtype),
                                       jax.random.PRNGKey(0))
    return (params, sc, state, interop.params_from_numpy(_np(params), "cpu"),
            interop.scenario_from_numpy(_np(sc), "cpu"),
            interop.state_from_numpy(_np(state), "cpu"))


def test_torch_batched_scan_runner_matches_jax_vmap(world16):
    """test_vmap_over_noise_seeds: 6 keys of split(PRNGKey(7), 6), frames
    1-20, impl 1; the port is fed normal(key_b, (20, 16, 2)) for each key,
    the draws the JAX runner scales by noise_std."""
    params, sc, state, tp_, tsc, tst = world16
    frames = jnp.arange(1, 21)
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    run_j = jdr.make_scan_runner(params, update_impl=1)
    st_j, errs_j, n_j, pos_j = jax.vmap(
        lambda k: run_j(state, sc, frames, k))(keys)
    noise = torch.as_tensor(np.stack([np.asarray(jax.random.normal(
        k, (20, 16, 2), jnp.float64)) for k in keys]))
    st_t, errs_t, n_t, pos_t, info_t = tdr.make_batched_scan_runner(tp_, 1)(
        tst, tsc, range(1, 21), noise)
    assert errs_t.shape == (6, 20) and pos_t.shape == (6, 20, 3)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(errs_t.numpy(), np.asarray(errs_j), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x), rtol=0,
                               atol=1e-8)
    assert torch.equal(st_t.P, st_t.P.mT)
    assert not info_t.any()
    assert float(errs_t[:, -1].std()) > 0
    run_1 = tdr.make_scan_runner(tp_, 1)
    for b in range(6):
        st_1, errs_1, n_1, pos_1, _ = run_1(tst, tsc, range(1, 21), noise[b])
        assert torch.equal(n_1, n_t[b])
        for got, want in ((errs_t[b], errs_1), (pos_t[b], pos_1),
                          (st_t.x[b], st_1.x), (st_t.P[b], st_1.P)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("impl", [2, 3, 4])
def test_torch_batched_scan_runner_other_impls(world16, impl):
    """Impls 2-4 at B = 2 over 10 frames, a state carrying its own leading
    B: each instance equals its unbatched run at 1e-12."""
    _, _, _, tp_, tsc, tst = world16
    noise = torch.as_tensor(np.random.default_rng(impl).standard_normal(
        (2, 10, 16, 2)))
    batched_state = type(tst)(*(torch.stack([t, t]) for t in tst))
    out = tdr.make_batched_scan_runner(tp_, impl)(batched_state, tsc,
                                                  range(1, 11), noise)
    run_1 = tdr.make_scan_runner(tp_, impl)
    for b in range(2):
        one = run_1(tst, tsc, range(1, 11), noise[b])
        assert torch.equal(out[2][b], one[2])
        assert torch.equal(out[4][b], one[4])
        for got, want in ((out[1][b], one[1]), (out[3][b], one[3]),
                          (out[0].x[b], one[0].x), (out[0].P[b], one[0].P)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-12)


def _lm_problems():
    """test_device_loop_vmaps_batch_ba's three problems in both packages."""
    probs = [j_circle_grid_problem(noise_pnt=0.06,
                                   rng=np.random.default_rng(s))[0]
             for s in (1, 2, 3)]
    return probs, [interop.ba_problem_from_numpy(_np(p), "cpu") for p in probs]


def test_torch_batched_lm_matches_jax_vmap():
    probs_j, probs_t = _lm_problems()
    kw = dict(err_thresh=1e-12, max_factor=1e12, max_iters=20)

    def run_one(p0):
        return jlm.run_lm_on_device(
            p0, blocks_fn=jd.compute_blocks,
            solve_fn=lambda _p, b, f: js.solve_corrections_schur(b, f),
            apply_fn=jd.apply_corrections, err_fn=jp.reproj_error, **kw)
    batched_j = jax.tree.map(lambda *xs: jnp.stack(xs), *probs_j)
    p_j, code_j, iters_j, err_j, trials_j = jax.jit(jax.vmap(run_one))(batched_j)

    t_kw = dict(blocks_fn=td.compute_blocks,
                solve_fn=lambda _p, b, f: ts.solve_corrections_schur(b, f),
                apply_fn=td.apply_corrections, err_fn=tp.reproj_error, **kw)
    graphs = [counts().get(c, 0) for c in ("ba.graph_captures",
                                           "ba.graph_replays")]
    r = tlmd.run_lm_on_device_batched(interop.stack(probs_t), **t_kw)
    p_t, code_t, iters_t, err_t, trials_t = r[:5]
    # a round is one set of launches for all problems: as many as the
    # problem that takes most
    assert r.trial_rounds == trials_t.max()
    assert r.outer_rounds >= iters_t.max()
    assert code_t.tolist() == np.asarray(code_j).tolist()
    assert iters_t.tolist() == np.asarray(iters_j).tolist()
    assert trials_t.tolist() == np.asarray(trials_j).tolist()
    np.testing.assert_allclose(err_t, np.asarray(err_j), rtol=1e-9, atol=1e-18)
    for name in ("points", "cfw_R", "cfw_t"):
        np.testing.assert_allclose(getattr(p_t, name).numpy(),
                                   np.asarray(getattr(p_j, name)), rtol=0,
                                   atol=1e-8)
    e0 = np.array([float(tp.reproj_error(p)) for p in probs_t])
    assert np.all(err_t < 0.2 * e0)
    for b, p in enumerate(probs_t):
        p1, code, iters, err, trials = tlmd.run_lm_on_device(p, **t_kw)
        assert (code, iters, trials) == (code_t[b], iters_t[b], trials_t[b])
        np.testing.assert_allclose(err_t[b], err, rtol=1e-9, atol=1e-18)
        np.testing.assert_allclose(p_t.points[b].numpy(), p1.points.numpy(),
                                   rtol=0, atol=1e-8)
    # the batch, and one problem off the card, engage no CUDA graph
    assert [counts().get(c, 0) for c in ("ba.graph_captures",
                                         "ba.graph_replays")] == graphs


@pytest.mark.parametrize("err_thresh,max_factor,max_iters,fail_below", [
    (None, 1e12, 4, None), (1e-12, None, 6, None), (1e-14, 1e12, 6, 1e-3),
    (1e-14, 5e-3, 6, 1e-3)])
def test_torch_batched_lm_criteria_match_unbatched(err_thresh, max_factor,
                                                    max_iters, fail_below):
    """Criteria left out (None) never fire; a solve that fails for a factor
    up to ``fail_below`` (ok = False, as test_torch_ba's forced failed
    factorization) damps up, and with the cap at 5e-3 stops on a hessian
    overflow: problem by problem as alone. The errors after a few
    iterations on these raw problems agree to 1e-6: the rounding of the
    batched products, amplified by the LM's steps (1.4e-8 seen)."""
    _, probs = _lm_problems()

    def solve(_p, b, f):
        if fail_below is not None:
            f = torch.where(torch.as_tensor(f) > fail_below,
                            torch.as_tensor(f, dtype=torch.float64), -2.0)
        return ts.solve_corrections_schur(b, f)
    kw = dict(blocks_fn=td.compute_blocks, solve_fn=solve,
              apply_fn=td.apply_corrections, err_fn=tp.reproj_error,
              err_thresh=err_thresh, max_factor=max_factor,
              max_iters=max_iters)
    _, code, iters, err, trials = tlmd.run_lm_on_device_batched(
        interop.stack(probs), **kw)[:5]
    for b, p in enumerate(probs):
        _, c1, i1, e1, t1 = tlmd.run_lm_on_device(p, **kw)
        assert (code[b], iters[b], trials[b]) == (c1, i1, t1)
        np.testing.assert_allclose(err[b], e1, rtol=1e-6, atol=1e-18)
    if fail_below is not None:
        assert (trials > iters + 1).all()
    if max_factor == 5e-3:
        assert (code == tlmd.STOP_HESSIAN_OVERFLOW).all()


def test_torch_batched_ba_leaves_a_degenerate_gauge_untouched():
    """normalize -> LM -> revert over four problems, one with cam1 = cam0
    (test_lm_device.py:92's degenerate gauge): it stops with
    STOP_CANNOT_NORMALIZE and comes back bit for bit; the others take
    their own device-loop path and land where they land alone."""
    _, probs = _lm_problems()
    bad = probs[0]._replace(
        cfw_R=torch.cat([probs[0].cfw_R[:1], probs[0].cfw_R[:1],
                         probs[0].cfw_R[2:]]),
        cfw_t=torch.cat([probs[0].cfw_t[:1], probs[0].cfw_t[:1],
                         probs[0].cfw_t[2:]]))
    batch = probs[:2] + [bad] + probs[2:]
    term = TermCriteria(allowed_reproj_err_rel_change=1e-12, max_iters=25)
    ba = BundleAdjustment(device_loop=True)
    p_out, code, iters, err, trials = ba.compute_batched(
        interop.stack(batch), term)[:5]
    assert code[2] == tlmd.STOP_CANNOT_NORMALIZE
    assert (iters[2], trials[2]) == (0, 0)
    for name in ("points", "cfw_R", "cfw_t", "K"):
        np.testing.assert_allclose(getattr(p_out, name)[2].numpy(),
                                   getattr(bad, name).numpy(), rtol=0, atol=0)
    for b in (0, 1, 3):
        ok, p1 = ba.compute_inplace(batch[b], term)
        assert (tlmd.STOP_REASON_STR[int(code[b])], iters[b], trials[b]) == (
            ba.stop_reason, ba.iterations, ba.trials)
        for name in ("points", "cfw_R", "cfw_t"):
            np.testing.assert_allclose(getattr(p_out, name)[b].numpy(),
                                       getattr(p1, name).numpy(), rtol=0,
                                       atol=1e-8)
    ok, _ = ba.compute_inplace(bad, term)
    assert not ok and ba.stop_reason == tlmd.STOP_REASON_STR[
        tlmd.STOP_CANNOT_NORMALIZE]


def test_torch_batch_ba_runner_converges_on_the_cpu():
    """``python -m surikatoko_tpu_torch.demos.batch_ba --batch 4`` on the
    CPU: every problem converges (err < 1e-4 e0), as the JAX demo's do, in
    the iterations the JAX demo prints (16/25/25)."""
    res = batch_ba.run(batch_ba.make_args(batch=4, device="cpu"),
                       log=lambda *_: None)
    assert res["converged"] == 4 and res["finite"]
    assert res["iters_min_med_max"] == [16, 25.0, 25]


@pytest.mark.parametrize("noise_pnt,noise_rot,n_angles,seed", [
    (0.0, 0.0, 4, None), (0.06, 0.01, 6, 3), (0.03, 0.02, 5, 7)])
def test_torch_circle_grid_fixture_matches_jax(noise_pnt, noise_rot,
                                               n_angles, seed):
    rng = (lambda: None) if seed is None else (
        lambda: np.random.default_rng(seed))
    pj, pts_j, cfw_j = j_circle_grid_problem(noise_pnt=noise_pnt,
                                             noise_rot=noise_rot,
                                             n_angles=n_angles, rng=rng())
    pt, pts_t, cfw_t = ba_scene.circle_grid_problem(
        noise_pnt=noise_pnt, noise_rot=noise_rot, n_angles=n_angles,
        rng=rng(), dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(pts_t, np.asarray(pts_j), rtol=0, atol=1e-12)
    for name in ("cfw_R", "cfw_t"):
        np.testing.assert_allclose(
            getattr(cfw_t, name[4:]).numpy(), np.asarray(getattr(cfw_j, name[4:])),
            rtol=0, atol=1e-12)
    for name in ("points", "cfw_R", "cfw_t", "K", "obs", "f0"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(pj, name)), rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(pt.obs_mask.numpy(), np.asarray(pj.obs_mask))


@pytest.mark.parametrize("name,kw", [
    ("crystall_grid_dataset", {}), ("crystall_grid_dataset", dict(n_frames=4)),
    ("circus_grid_dataset", {}), ("circus_grid_dataset", dict(n_frames=5))])
def test_torch_test_data_builder_matches_jax(name, kw):
    dj = getattr(jtdb, name)(**kw)
    dt = getattr(ttdb, name)(**kw, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(dt.points, np.asarray(dj.points), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dt.cfw.R.numpy(), np.asarray(dj.cfw.R), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dt.cfw.t.numpy(), np.asarray(dj.cfw.t), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(dt.K, dj.K)
    for noise in (0.0, 0.5):
        obs_j, mask_j = jtdb.project_dataset(dj, noise_pix=noise, seed=3)
        obs_t, mask_t = ttdb.project_dataset(dt, noise_pix=noise, seed=3)
        np.testing.assert_array_equal(mask_t, mask_j)
        np.testing.assert_allclose(obs_t, obs_j, rtol=0, atol=1e-12)
