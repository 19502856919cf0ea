"""Multi-view factorization of the PyTorch port against the JAX package, in
float64 on the CPU, on the inputs of tests/test_mvf.py.

- relative_motion's four functions, to 1e-10: the SVD-12 relative motion
  (exact, noisy, masked rows holding garbage, and with the SVD's null
  vector and singular vector pairs negated), the GN-PnP polish (a batch of
  two, masked rows), the GN point polish and the MASKS-8.44 depth (batched
  over tracks as the JAX package vmaps them, a clamped depth included);
  the closed-form projection Jacobians against ``torch.func.jacfwd``.
- ``TrackStore``: bit for bit.
- The factorizer frame by frame on test_mvf.py's ``run_mvf`` worlds (exact;
  the GT switches): after every frame the poses and the map within 1e-8,
  the map's track ids and ``ba_runs`` equal. The noisy world is in
  test_torch_mvf_sparse.py.
- ``interop.mvf_from_numpy``: a JAX factorizer's state carried mid-run, then
  both go on to the end.
- The demo's SE(3) loop closure (``demos.multi_view_factorization`` with
  ``loop_closure``) on test_mvf.py:171's world (12 frames, 1.5 px, seed 5)
  against that test's JAX run: run_mvf, then ``apply_pose_graph`` with the
  two GT closure edges and the pinned BA. Poses and map within 1e-8 after
  the closure, the end errors before and after it within 1e-8, ``ba_runs``
  equal. The demo's grid equals the JAX world's bit for bit, its path
  within 1e-14 (the look-at rounds in XLA's and torch's own ways).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surikatoko_tpu.geom.se3 import SE3 as JSE3
from surikatoko_tpu.models.mvf import MultiViewFactorizer as JMVF
from surikatoko_tpu.models.mvf import TrackStore as JTS
from surikatoko_tpu.models.mvf import relative_motion as jrm
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.demos import multi_view_factorization as tdemo
from surikatoko_tpu_torch.models.mvf import MultiViewFactorizer as TMVF
from surikatoko_tpu_torch.models.mvf import TrackStore as TTS
from surikatoko_tpu_torch.models.mvf import relative_motion as trm

from test_mvf import K, K_INV, make_world, project, run_mvf

torch.set_num_threads(2)
RM_TOL = dict(rtol=0, atol=1e-10)
MVF_TOL = 1e-8


def _t(a):
    return torch.as_tensor(np.array(a))


def _cam(gt_cfw, f):
    return np.asarray(gt_cfw.R[f]), np.asarray(gt_cfw.t[f])


def _two_views(noise=0.0, seed=0):
    """test_mvf.py's frames 0 and 2: (c1, c2, depths, R_gt, t_gt)."""
    points, gt_cfw = make_world()
    (R0, t0), (R2, t2) = _cam(gt_cfw, 0), _cam(gt_cfw, 2)
    xc0, xc2 = points @ R0.T + t0, points @ R2.T + t2
    c2 = xc2 / xc2[:, 2:3]
    if noise:
        c2 = c2 + np.random.default_rng(seed).normal(scale=noise,
                                                      size=c2.shape)
        c2[:, 2] = 1.0
    R_gt = R2 @ R0.T
    return xc0 / xc0[:, 2:3], c2, xc0[:, 2], R_gt, t2 - R_gt @ t0


def _rel_both(c1, c2, d, mask):
    rj, okj = jrm.find_relative_motion_multi_points(
        jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(d), jnp.asarray(mask))
    rt, okt = trm.find_relative_motion_multi_points(
        _t(c1), _t(c2), _t(d), _t(mask))
    return rj, bool(okj), rt, bool(okt)


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_torch_relative_motion_matches_jax(noise):
    c1, c2, d, R_gt, t_gt = _two_views(noise)
    rj, okj, rt, okt = _rel_both(c1, c2, d, np.ones(len(c1), bool))
    assert okj and okt
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), **RM_TOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), **RM_TOL)
    if not noise:
        np.testing.assert_allclose(rt.R.numpy(), R_gt, atol=1e-10)
        np.testing.assert_allclose(rt.t.numpy(), t_gt, atol=1e-9)


def test_torch_relative_motion_masked_rows_match_jax():
    """test_relative_motion_masked_rows_ignored: garbage in masked rows."""
    c1, c2, d, R_gt, _ = _two_views()
    c2 = c2.copy()
    c2[:5] = np.random.default_rng(20260817).normal(size=(5, 3))
    mask = np.ones(len(c1), bool)
    mask[:5] = False
    rj, okj, rt, okt = _rel_both(c1, c2, d, mask)
    assert okj == okt
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), **RM_TOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), **RM_TOL)
    np.testing.assert_allclose(rt.R.numpy(), R_gt, atol=1e-10)


def test_torch_relative_motion_ignores_the_svds_signs(monkeypatch):
    """Every SVD negates its last singular vector pair (the 3N x 12 null
    vector among them, and (u3, v3) of the 3x3 projection, another valid
    SVD): R and T come out the same."""
    c1, c2, d, _, _ = _two_views(1e-3)
    mask = _t(np.ones(len(c1), bool))
    args = (_t(c1), _t(c2), _t(d), mask)
    ref, ok_ref = trm.find_relative_motion_multi_points(*args)
    svd = torch.linalg.svd

    def flipped(A, *a, **kw):
        U, S, Vh = svd(A, *a, **kw)
        U, Vh = U.clone(), Vh.clone()
        U[..., :, S.shape[-1] - 1] *= -1
        Vh[..., S.shape[-1] - 1, :] *= -1
        return U, S, Vh

    monkeypatch.setattr(torch.linalg, "svd", flipped)
    out, ok = trm.find_relative_motion_multi_points(*args)
    assert bool(ok) and bool(ok_ref)
    np.testing.assert_allclose(out.R.numpy(), ref.R.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(out.t.numpy(), ref.t.numpy(), rtol=0, atol=1e-13)


def _pnp_case():
    """Frame 3's view of the world with pixel noise, 5 rows masked with
    garbage, and a perturbed initial pose."""
    rng = np.random.default_rng(7)
    points, gt_cfw = make_world()
    R3, t3 = _cam(gt_cfw, 3)
    xc = points @ R3.T + t3
    obs = xc / xc[:, 2:3]
    obs[:, :2] += rng.normal(scale=2e-3, size=(len(obs), 2))
    mask = np.ones(len(obs), bool)
    mask[:5] = False
    obs[:5] = rng.normal(size=(5, 3))
    from surikatoko_tpu.geom import so3
    R0 = np.asarray(so3.exp(jnp.asarray([0.02, -0.03, 0.01]))) @ R3
    return points, obs, mask, R0, t3 + np.array([0.05, -0.02, 0.04]), R3, t3


def test_torch_refine_pose_pnp_matches_jax():
    points, obs, mask, R0, t0, R3, t3 = _pnp_case()
    Rj, tj, rmsj = jax.jit(jrm.refine_pose_pnp)(
        jnp.asarray(points), jnp.asarray(obs), jnp.asarray(mask),
        jnp.asarray(R0), jnp.asarray(t0))
    # a batch of two: the same problem from the guess and from the GT pose
    Rt, tt, rmst = trm.refine_pose_pnp(
        _t(points).expand(2, -1, -1), _t(obs).expand(2, -1, -1),
        _t(mask).expand(2, -1), _t(np.stack([R0, R3])), _t(np.stack([t0, t3])))
    np.testing.assert_allclose(Rt[0].numpy(), np.asarray(Rj), **RM_TOL)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), **RM_TOL)
    np.testing.assert_allclose(float(rmst[0]), float(rmsj), rtol=1e-10)
    Rg, tg, _ = jax.jit(jrm.refine_pose_pnp)(
        jnp.asarray(points), jnp.asarray(obs), jnp.asarray(mask),
        jnp.asarray(R3), jnp.asarray(t3))
    np.testing.assert_allclose(Rt[1].numpy(), np.asarray(Rg), **RM_TOL)
    np.testing.assert_allclose(tt[1].numpy(), np.asarray(tg), **RM_TOL)


def _tracks_case():
    """Tracks of test_mvf.py's world seen from frame 0 and frames 1-4 (some
    frames masked, pixel noise), perturbed points as the initial points,
    and track 3's initial point moved onto frame 1's camera plane (a
    clamped depth: for the Jacobians, not for the GN polish, whose first
    step from there is ~1e9 and rounds chaotically in both packages)."""
    rng = np.random.default_rng(11)
    points, gt_cfw = make_world()
    sel = np.arange(0, len(points), 7)[:24]
    R0, t0 = _cam(gt_cfw, 0)
    fr = [_cam(gt_cfw, f) for f in (1, 2, 3, 4)]
    N, M = len(sel), 4
    x_base = np.zeros((N, 3))
    xs = np.zeros((N, M, 3))
    R_fb = np.zeros((N, M, 3, 3))
    T_fb = np.zeros((N, M, 3))
    obs_w = np.zeros((N, M + 1, 3))
    R_w = np.zeros((N, M + 1, 3, 3))
    t_w = np.zeros((N, M + 1, 3))
    for i, p in enumerate(points[sel]):
        xc = R0 @ p + t0
        x_base[i] = xc / xc[2]
        obs_w[i, 0], R_w[i, 0], t_w[i, 0] = x_base[i], R0, t0
        for k, (R, t) in enumerate(fr):
            xk = R @ p + t
            xs[i, k] = xk / xk[2]
            xs[i, k, :2] += rng.normal(scale=1e-3, size=2)
            R_fb[i, k] = R @ R0.T
            T_fb[i, k] = t - R_fb[i, k] @ t0
            obs_w[i, k + 1], R_w[i, k + 1], t_w[i, k + 1] = xs[i, k], R, t
    mask = rng.uniform(size=(N, M)) > 0.25
    mask[:, 0] = True
    mask_w = np.concatenate([np.ones((N, 1), bool), mask], axis=1)
    x0 = points[sel] + rng.normal(scale=0.05, size=(N, 3))
    R1, t1 = fr[0]
    x0_clamped = x0.copy()
    x0_clamped[3] = x0[3] - (R1 @ x0[3] + t1)[2] * R1[2]
    return (x_base, xs, R_fb, T_fb, mask, x0, obs_w, R_w, t_w, mask_w,
            x0_clamped)


def test_torch_estimate_point_depth_matches_jax():
    x_base, xs, R_fb, T_fb, mask, *_ = _tracks_case()
    dj = jax.jit(jax.vmap(jrm.estimate_point_depth))(
        *map(jnp.asarray, (x_base, xs, R_fb, T_fb, mask)))
    dt = trm.estimate_point_depth(*map(_t, (x_base, xs, R_fb, T_fb, mask)))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-10)
    # one track alone gives its row of the batch
    d0 = trm.estimate_point_depth(*(_t(a[0]) for a in (x_base, xs, R_fb,
                                                       T_fb, mask)))
    np.testing.assert_allclose(float(d0), float(dt[0]), rtol=1e-14)


def test_torch_refine_point_gn_matches_jax():
    *_, x0, obs_w, R_w, t_w, mask_w, _ = _tracks_case()
    xj = jax.jit(jax.vmap(jrm.refine_point_gn))(
        *map(jnp.asarray, (x0, obs_w, R_w, t_w, mask_w)))
    xt = trm.refine_point_gn(*map(_t, (x0, obs_w, R_w, t_w, mask_w)))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **RM_TOL)


def test_torch_closed_form_jacobians_match_jacfwd():
    """The 2x6 pose and 2x3 point projection Jacobians against
    torch.func.jacfwd of the residuals (the JAX package's jax.jacfwd), a
    clamped depth included."""
    from torch.func import jacfwd
    from surikatoko_tpu_torch.geom import so3
    points, obs, mask, R0, t0, *_ = _pnp_case()
    P, O, m = _t(points), _t(obs), _t(mask).double()
    R, t = _t(R0), _t(t0)

    def pose_res(w, dt):
        return trm.pose_residuals_and_jacobian(
            P, O, m, so3.exp(w) @ R, t + dt)[0].reshape(-1)

    z = torch.zeros(3, dtype=torch.float64)
    Jw, Jt = jacfwd(pose_res, argnums=(0, 1))(z, z)
    _, J = trm.pose_residuals_and_jacobian(P, O, m, R, t)
    np.testing.assert_allclose(J.reshape(-1, 6).numpy(),
                               torch.cat([Jw, Jt], dim=1).numpy(),
                               rtol=1e-12, atol=1e-12)
    *_, obs_w, R_w, t_w, mask_w, x0 = _tracks_case()
    for i in (0, 3):
        args = (_t(obs_w[i]), _t(mask_w[i]).double(), _t(R_w[i]), _t(t_w[i]))

        def point_res(X):
            return trm.point_residuals_and_jacobian(X, *args)[0].reshape(-1)

        X = _t(x0[i])
        Jp = jacfwd(point_res)(X)
        _, J = trm.point_residuals_and_jacobian(X, *args)
        np.testing.assert_allclose(J.reshape(-1, 3).numpy(), Jp.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_torch_track_store_matches_jax_bitwise():
    rng = np.random.default_rng(5)
    stores = (JTS(40, 12, 6), TTS(40, 12, 6))
    for f in range(12):
        for tid in rng.choice(40, size=15, replace=False):
            pix = rng.uniform(0, 320, size=2)
            for ts in stores:
                ts.add_corner(int(tid), f, pix, K_INV)
        # a re-reported corner overwrites its frame's entry
        for ts in stores:
            ts.add_corner(3, f, (10.0 + f, 20.0), K_INV)
    js, ts = stores
    for name in ("coords", "pixels", "fidx", "count", "n_tracks", "L"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert ts._frame_tracks == js._frame_tracks
    assert ts.n_obs() == js.n_obs()
    for f in range(12):
        np.testing.assert_array_equal(ts.tracks_in_frame(f),
                                      js.tracks_in_frame(f))
    for tid in range(40):
        assert ts.slot_of(tid, 7) == js.slot_of(tid, 7)
    for out_t, out_j in zip(ts.sparse_observations(range(40), 9, 6),
                            js.sparse_observations(range(40), 9, 6)):
        np.testing.assert_array_equal(out_t, out_j)


# ---- the factorizer, frame by frame ----------------------------------------

def snapshot(m) -> dict:
    return {"R": np.stack(m.cam_cfw_R).astype(np.float64),
            "t": np.stack(m.cam_cfw_t).astype(np.float64),
            "points": {int(k): np.asarray(v, np.float64)
                       for k, v in m.point_coords.items()},
            "ba_runs": m.ba_runs}


def compare(a: dict, b: dict, tol: float, where="") -> float:
    """Max |difference| of two snapshots; raises past ``tol`` or on unequal
    track ids or BA counts."""
    assert a["ba_runs"] == b["ba_runs"], where
    assert sorted(a["points"]) == sorted(b["points"]), where
    d = max(np.abs(a["R"] - b["R"]).max(), np.abs(a["t"] - b["t"]).max(),
            max((np.abs(a["points"][k] - b["points"][k]).max()
                 for k in a["points"]), default=0.0))
    assert d <= tol, (where, d, tol)
    return d


def run_world(factorizers, frames=10, noise_pix=0.0, seed=0, scale=1.0,
              start=0, stop=None):
    """test_mvf.py's run_mvf over several factorizers at once (the same
    corners into each one's track store); returns each frame's snapshots
    [(snap, ...) per frame]. ``scale`` multiplies the world points (a
    1e-15 change measures the JAX package's own rounding sensitivity);
    ``start`` skips the frames a carried state already holds."""
    rng = np.random.default_rng(seed)
    points, gt_cfw = make_world(frames)
    points = points * scale
    n_frames = min(frames, gt_cfw.t.shape[0]) if stop is None else stop
    snaps = []
    for f in range(n_frames):
        pix, vis = project(points, gt_cfw, f, noise_pix, rng)
        if f < start:
            continue
        for m in factorizers:
            for tid in np.nonzero(vis)[0]:
                m.track_store.add_corner(int(tid), f, pix[tid], K_INV)
            if f < 2:
                m.add_known_frame(JSE3(*_cam(gt_cfw, f)))
                for tid in np.nonzero(vis)[0]:
                    m.set_known_point(int(tid), points[tid])
            else:
                assert m.integrate_new_frame_corners(), (type(m), f)
        snaps.append(tuple(snapshot(m) for m in factorizers))
    return snaps


def make_pair(frames=10, **kw):
    """A JAX and a port factorizer on test_mvf.py's world (port on the CPU,
    float64)."""
    points, gt_cfw = make_world(frames)
    n = min(frames, gt_cfw.t.shape[0])
    gt = dict(gt_cfw_fun=lambda f: JSE3(*_cam(gt_cfw, f)),
              gt_point_fun=lambda tid: points[tid])
    j = JMVF(track_store=JTS(len(points), n), K=K, **gt, **kw)
    t = TMVF(track_store=TTS(len(points), n), K=K, device="cpu", **gt, **kw)
    return j, t


@pytest.fixture(scope="module")
def exact_run():
    j, t = make_pair()
    return j, t, run_world((j, t))


def test_torch_mvf_exact_frame_by_frame_matches_jax(exact_run):
    j, t, snaps = exact_run
    for f, (a, b) in enumerate(snaps):
        compare(a, b, MVF_TOL, f"frame {f}")
    assert len(t.point_coords) > 40 and t.ba_runs == 0


def test_torch_mvf_fake_switches_match_jax():
    """test_mvf_fake_switches: GT poses and points substituted; the map is
    the GT map."""
    j, t = make_pair(frames=8, fake_localization=True, fake_mapping=True,
                     ba_trigger_reproj_err=1e12)
    snaps = run_world((j, t), frames=8)
    for f, (a, b) in enumerate(snaps):
        compare(a, b, MVF_TOL, f"frame {f}")
    points, _ = make_world(8)
    for tid, xyz in t.point_coords.items():
        np.testing.assert_allclose(xyz, points[tid], atol=1e-9)


def test_torch_mvf_from_numpy_carries_the_state(exact_run):
    """A JAX factorizer stopped after frame 5, carried into the port, and
    both run on to frame 9: equal, frame by frame."""
    j, _ = make_pair()
    run_world((j,), stop=6)
    t = interop.mvf_from_numpy(j, device="cpu")
    assert t.device == torch.device("cpu") and t.dtype == torch.float64
    for name in ("coords", "pixels", "fidx", "count"):
        np.testing.assert_array_equal(getattr(t.track_store, name),
                                      getattr(j.track_store, name))
    assert t.track_store._frame_tracks == j.track_store._frame_tracks
    compare(snapshot(j), snapshot(t), 0.0)
    assert t._ba_points == j._ba_points
    assert (t.ba_trigger_reproj_err, t.min_parallax_ratio, t.ba_max_iters) == (
        j.ba_trigger_reproj_err, j.min_parallax_ratio, j.ba_max_iters)
    snaps = run_world((j, t), start=6)
    for f, (a, b) in enumerate(snaps, start=6):
        compare(a, b, MVF_TOL, f"frame {f}")
    compare(snaps[-1][1], exact_run[2][-1][1], MVF_TOL, "against one run")


def test_torch_mvf_measure_relative_pose_matches_jax(exact_run):
    j, t, _ = exact_run
    rj, nj = j.measure_relative_pose(2, 7)
    rt, nt = t.measure_relative_pose(2, 7)
    assert nj == nt >= 6
    np.testing.assert_allclose(rt.R, np.asarray(rj.R), **RM_TOL)
    np.testing.assert_allclose(rt.t, np.asarray(rj.t), **RM_TOL)
    # too thin a support: no measurement, the same count
    assert t.measure_relative_pose(2, 7, min_common=10_000) == (
        None, j.measure_relative_pose(2, 7, min_common=10_000)[1])


def _jax_closure_run():
    """test_mvf.py::test_mvf_pose_graph_loop_closure's JAX run: (snapshot
    before the closure, end error before, factorizer after)."""
    mvf, points, gt_cfw, n = run_mvf(frames=12, noise_pix=1.5, seed=5)
    before = snapshot(mvf)
    gt_pos = np.stack([-np.asarray(gt_cfw.R[f]).T @ np.asarray(gt_cfw.t[f])
                       for f in range(n)])
    end_err = lambda: float(np.linalg.norm(
        -(mvf.cam_cfw_R[-1].T @ mvf.cam_cfw_t[-1]) - gt_pos[-1]))
    end_before = end_err()
    closures = []
    i = n - 1
    for j in (0, 1):
        Ri, ti = np.asarray(gt_cfw.R[i]), np.asarray(gt_cfw.t[i])
        Rj, tj = np.asarray(gt_cfw.R[j]), np.asarray(gt_cfw.t[j])
        rel_R = Rj @ Ri.T
        closures.append((i, j, JSE3(rel_R, tj - rel_R @ ti), 3.0))
    mvf.apply_pose_graph(closures, run_ba=True)
    return before, end_before, end_err(), mvf


def test_torch_mvf_demo_world_equals_jax():
    """The grid bit for bit, the rectangular path within 1e-14 (one ulp of
    the look-at's rounding)."""
    points, R, t = tdemo.make_world(12)
    pj, gj = make_world(12)
    np.testing.assert_array_equal(points, np.asarray(pj))
    np.testing.assert_allclose(R, np.asarray(gj.R), rtol=0, atol=1e-14)
    np.testing.assert_allclose(t, np.asarray(gj.t), rtol=0, atol=1e-14)


def test_torch_mvf_demo_pose_graph_closure_matches_jax():
    before_j, end_before_j, end_after_j, j = _jax_closure_run()
    t, res = tdemo.run_factorizer(frames=12, noise_pix=1.5, loop_closure=True,
                                  seed=5, device="cpu")
    np.testing.assert_allclose(res["end_err_before_closure"], end_before_j,
                               rtol=0, atol=MVF_TOL)
    np.testing.assert_allclose(res["end_err_after_closure"], end_after_j,
                               rtol=0, atol=MVF_TOL)
    compare(snapshot(j), snapshot(t), MVF_TOL, "after the closure")
    assert res["ba_runs"] == j.ba_runs == before_j["ba_runs"] + 1
    # the closure's BA ran with the closure frames pinned
    assert t.ba_log[-1][:2] == ("dense", True)
    assert end_after_j < 0.2 * end_before_j
    assert res["end_err_after_closure"] < 0.2 * res["end_err_before_closure"]
    for R in t.cam_cfw_R:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-8)


def _so3_departure(m) -> float:
    R = np.stack(m.cam_cfw_R).astype(np.float64)
    return float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())


def test_torch_mvf_global_ba_keeps_rotations_on_so3(monkeypatch):
    """ROADMAP C.3: the BA's gauge round trip maps R_0 to R_0 R_0^T R_0, so
    a rotation's departure from SO(3) triples with every global BA. In
    float32 (the demo's world, 0.5 px, 10 BA runs, then the SE(3) closure
    with frames 0, 1 and 11 pinned) the port's rotations stay on SO(3), the
    pinned last camera stays where the closure put it, and the map is as
    good as float64's. Keeping the rotations as the BA returns them (the
    JAX package's factorizer.py:1007-1009) leaves SO(3) by > 1e-3, the
    pinned frames then move within the closure BA, which ends without
    success, so its result is dropped and the map stays as the pose graph
    left it: point ATE past 2 x float64's + 0.01."""
    from surikatoko_tpu_torch.models.mvf import factorizer
    kw = dict(frames=12, noise_pix=0.5, loop_closure=True, seed=0,
              device="cpu")
    _, r64 = tdemo.run_factorizer(dtype=torch.float64, **kw)
    m32, r32 = tdemo.run_factorizer(dtype=torch.float32, **kw)
    assert _so3_departure(m32) < 1e-5
    assert r32["point_ate"] <= 2 * r64["point_ate"] + 0.01
    assert r32["end_err_after_closure"] <= 2 * r64["end_err_after_closure"]
    monkeypatch.setattr(factorizer, "_nearest_rotations", lambda R: R)
    m_ref, r_ref = tdemo.run_factorizer(dtype=torch.float32, **kw)
    assert _so3_departure(m_ref) > 1e-3
    assert m_ref.ba_log[-1][1] is False and m32.ba_log[-1][1] is True
    assert r_ref["point_ate"] > 2 * r64["point_ate"] + 0.01
