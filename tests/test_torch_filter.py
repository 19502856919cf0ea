"""The ported host-driven tracker (MonoSlamFilter, DemoCornersMatcher,
run_scenario) against the JAX package, in float64 on the CPU, on
tests/test_monoslam_closed_loop.py's scenarios: the same world, poses and
parameters go to both, and both matchers draw from default_rng(seed) in the
same order. Per frame: cam_state within 1e-9 (impls 1-3; impl 4 at
test_torch_update.py's 1e-12), and obs, new and deleted counts and new slots
equal; the port's P == P^T bit for bit after every frame. Each case also
carries the reference test's own assertions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.geom.se3 import SE3 as JSE3
from surikatoko_tpu.models.monoslam import MonoSlamFilter as JFilter
from surikatoko_tpu.models.monoslam import filter as jfilter
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.world import scene_gen as jscene
from surikatoko_tpu.world.demo_matcher import DemoCornersMatcher as JMatcher
from surikatoko_tpu.world.runner import gt_poses_in_tracker_frame as j_gt_poses
from surikatoko_tpu.world.runner import run_scenario as j_run_scenario
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.geom.se3 import SE3 as TSE3
from surikatoko_tpu_torch.models.monoslam import filter as tfilter
from surikatoko_tpu_torch.world import runner as trunner
from surikatoko_tpu_torch.world.demo_matcher import DemoCornersMatcher as TMatcher

torch.set_num_threads(2)
CAM_TOL = {1: 1e-9, 2: 1e-9, 3: 1e-9, 4: 1e-12}


class CheckedFilter(tfilter.MonoSlamFilter):
    """The port's filter, asserting P == P^T bit for bit after every step."""

    def process_frame(self, *args, **kw):
        state, stats = super().process_frame(*args, **kw)
        assert torch.equal(state.P, state.P.T), "P != P^T after a frame"
        return state, stats


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _world(scenario="03"):
    """(gt_cfw in the tracker frame, points in the tracker frame) of
    test_monoslam_closed_loop's scenario03 or scenario01, or of the bench's
    96-point scenario03 world ("03_k96", build_oscillating_scenario), as JAX
    makes them."""
    if scenario == "03_k96":
        from surikatoko_tpu.world.device_runner import build_oscillating_scenario
        sc = build_oscillating_scenario(96, dtype=jnp.float64)
        return JSE3(sc.gt_cfw_R, sc.gt_cfw_t), np.asarray(sc.gt_points)
    if scenario == "03":
        wb = jscene.WorldBounds(0.0, 0.6, 0.0, 0.6, 0.0, 0.6001)
        points_world = jscene.generate_grid_points(wb, (0.5, 0.5, 0.5), 0.2)
        center = np.array([0.3, 0.3, 0.3])
        gt_cfw_world = jscene.oscillate_right_and_left(
            center + np.array([0, -1.5, 0]), center, (0, 0, 1),
            max_deviation=0.6, periods_count=2, shots_per_period=160,
            const_view_dir=True)
    else:
        wb = jscene.WorldBounds(-1.5, 1.5, -1.5, -0.4, 0.0, 0.0001)
        points_world = jscene.generate_grid_points(wb, (0.5, 0.5, 0.5), 0.0)
        gt_cfw_world = jscene.rectangular_path(wb, 10, 10, (3, -2, 7), (0, 0, 0),
                                               (0, 0, 1))
    gt_cfw = j_gt_poses(gt_cfw_world)
    tfw = JSE3(gt_cfw_world.R[0], gt_cfw_world.t[0])
    pts = np.asarray(jnp.einsum("ij,nj->ni", tfw.R, jnp.asarray(points_world))
                     + tfw.t)
    return gt_cfw, pts


def make_pair(impl=1, capacity=32, scenario="03", repres=2, matcher_kw=None,
              **param_kw):
    """(JAX tracker, matcher, gt_cfw), (port tracker, matcher, gt_cfw) on
    the same world and parameters."""
    gt_cfw, pts = _world(scenario)
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01))
    dist = (jcam.MikhailDistortion(jnp.float64(0.06), jnp.float64(0.01))
            if scenario == "01" else None)
    kw = dict(dt=1.0, process_noise_lin_veloc_std=0.075,
              process_noise_ang_veloc_std=0.01, sal_pnt_repres=repres)
    kw.update(param_kw)
    params = j_make_params(cam, dist, **kw)
    mkw = {"seed": 1, **(matcher_kw or {})}
    j_tr = JFilter(params, capacity=capacity, update_impl=impl)
    j_m = JMatcher(j_tr, gt_cfw, pts, **mkw)
    t_gt = interop.se3_from_numpy(_np(gt_cfw), device="cpu")
    t_tr = CheckedFilter(interop.params_from_numpy(_np(params), device="cpu"),
                         capacity=capacity, update_impl=impl)
    t_m = TMatcher(t_tr, t_gt, pts, **mkw)
    return (j_tr, j_m, gt_cfw), (t_tr, t_m, t_gt)


def compare_runs(res_j, res_t, cam_tol):
    assert len(res_j.stats) == len(res_t.stats)
    for f, (sj, st) in enumerate(zip(res_j.stats, res_t.stats)):
        for name in ("obs_count", "new_count", "deleted_count",
                     "estimated_count", "frame_ind"):
            assert int(getattr(st, name)) == int(getattr(sj, name)), (f, name)
        np.testing.assert_array_equal(st.new_slots.numpy(),
                                      np.asarray(sj.new_slots))
        np.testing.assert_allclose(st.cam_state.numpy(), np.asarray(sj.cam_state),
                                   rtol=0, atol=cam_tol, err_msg=f"frame {f}")
        np.testing.assert_allclose(st.cam_pos_cov.numpy(),
                                   np.asarray(sj.cam_pos_cov), rtol=1e-6,
                                   atol=1e-12)
    np.testing.assert_allclose(res_t.cam_pos_gt, res_j.cam_pos_gt, rtol=0,
                               atol=1e-12)


def _sigma(res):
    return np.array([np.sqrt(np.trace(np.asarray(s.cam_pos_cov)))
                     for s in res.stats])


@pytest.mark.parametrize("impl", [1, 2, 3])
def test_torch_scenario03_matches_jax_within_sigma_envelope(impl):
    """test_scenario03_within_sigma_envelope: 40 frames, detection noise
    0.5, both packages; the port's error within 3 sigma and < 0.2."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(impl, matcher_kw=dict(
        detection_noise_std=0.5))
    res_j = j_run_scenario(jt, jm, jg, n_frames=40)
    res_t = trunner.run_scenario(tt, tm, tg, n_frames=40)
    compare_runs(res_j, res_t, CAM_TOL[impl])
    assert (res_t.cam_pos_err <= 3 * _sigma(res_t) + 1e-9).all()
    assert res_t.cam_pos_err.max() < 0.2
    if impl == 1:   # test_scenario03_residual_matches_noise_level
        errs = [float(s.opt_reproj_err) for s in res_t.stats[10:]]
        assert 0.05 < np.mean(errs) < 1.5


def test_torch_k96_world_matches_jax():
    """The 96-landmark scenario03 world of chip_smoke's hostloop phase
    (detection noise 0.5 from default_rng(3), the whole capacity as frame
    0's budget), 30 frames. Here the bad-ellipsoid test decides deletions:
    JAX forms the 3x3 minors, the port takes the Cholesky pivots, and the
    deleted counts and slots must agree frame by frame, and the two masks
    on the end state."""
    from surikatoko_tpu.models.monoslam import health as jhealth
    from surikatoko_tpu_torch.models.monoslam import health as thealth
    (jt, jm, jg), (tt, tm, tg) = make_pair(1, capacity=96, scenario="03_k96",
                                           matcher_kw=dict(
        detection_noise_std=0.5, seed=3, max_new_in_first_frame=96))
    res_j = j_run_scenario(jt, jm, jg, n_frames=30)
    res_t = trunner.run_scenario(tt, tm, tg, n_frames=30)
    compare_runs(res_j, res_t, CAM_TOL[1])
    assert int(res_t.stats[0].new_count) == 96
    sub_j = jt.params.sal_pnt_negative_inv_rho_substitute
    want = np.asarray(jhealth.bad_uncertainty_mask(
        res_j.state.x, res_j.state.P, 96, sub_j))
    got = thealth.bad_uncertainty_mask(
        res_t.state.x, res_t.state.P, 96,
        tt.params.sal_pnt_negative_inv_rho_substitute)
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_scenario03_ransac_matches_jax():
    """test_scenario03_ransac_tracks with impl 4."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(4, matcher_kw=dict(
        detection_noise_std=0.5))
    res_j = j_run_scenario(jt, jm, jg, n_frames=40)
    res_t = trunner.run_scenario(tt, tm, tg, n_frames=40)
    compare_runs(res_j, res_t, CAM_TOL[4])
    assert res_t.cam_pos_err.max() < 0.4
    assert int(res_t.stats[-1].estimated_count) == 8
    for sj, st in zip(res_j.stats, res_t.stats):
        assert int(st.ransac_low) == int(sj.ransac_low)
        assert int(st.ransac_high) == int(sj.ransac_high)
    for s in res_t.stats[5:]:
        assert int(s.ransac_low) + int(s.ransac_high) <= int(s.obs_count)


def test_torch_scenario03_dropped_matches_match_jax():
    """test_scenario03_with_dropped_matches: 30% of matches dropped; the
    drop draws come from the same generator in the same order."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(1, matcher_kw=dict(
        detection_noise_std=0.5, match_drop_prob=0.3))
    res_j = j_run_scenario(jt, jm, jg, n_frames=40)
    res_t = trunner.run_scenario(tt, tm, tg, n_frames=40)
    compare_runs(res_j, res_t, CAM_TOL[1])
    assert (res_t.cam_pos_err <= 3 * _sigma(res_t) + 1e-9).all()


def test_torch_scenario03_xyz_matches_jax():
    """The XYZ representation, where the step skips the rho substitution.
    Capacity 8, so frame 0 fills every slot: a free XYZ slot sits at the
    origin, which JAX's masked update turns into NaN (ROADMAP C.3; the
    next test)."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(1, capacity=8, repres=1,
                                           matcher_kw=dict(detection_noise_std=0.5))
    res_j = j_run_scenario(jt, jm, jg, n_frames=30)
    res_t = trunner.run_scenario(tt, tm, tg, n_frames=30)
    compare_runs(res_j, res_t, CAM_TOL[1])
    assert res_t.cam_pos_err.max() < 0.5


def test_torch_scenario03_xyz_with_free_slots_tracks():
    """XYZ with free slots (capacity 32, 8 points): JAX's update turns NaN
    on frame 1 and every landmark is deleted; the port's masked Jacobians
    contribute zeros (ROADMAP C.2), so it keeps the 8 and tracks."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(1, repres=1, matcher_kw=dict(
        detection_noise_std=0.5))
    res_j = j_run_scenario(jt, jm, jg, n_frames=2)
    assert int(res_j.stats[1].deleted_count) == 8
    res_t = trunner.run_scenario(tt, tm, tg, n_frames=30)
    assert all(int(s.deleted_count) == 0 for s in res_t.stats)
    assert int(res_t.stats[-1].estimated_count) == 8
    assert res_t.cam_pos_err.max() < 0.5


def test_torch_scenario01_distorted_matches_jax():
    """test_scenario01_rectangular_path_tracks: distortion, no noise."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(1, scenario="01",
                                           process_noise_lin_veloc_std=0.15)
    res_j = j_run_scenario(jt, jm, jg, n_frames=15)
    res_t = trunner.run_scenario(tt, tm, tg, n_frames=15)
    compare_runs(res_j, res_t, CAM_TOL[1])
    assert res_t.cam_pos_err.max() < 0.35
    assert float(res_t.stats[-1].opt_reproj_err) < 0.5


def test_torch_observation_suppression_grows_uncertainty():
    """The 's' hotkey: with observations suppressed the filter coasts on
    the motion model and the camera covariance grows every frame; the same
    traces as JAX's."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(1)
    res_j = j_run_scenario(jt, jm, jg, n_frames=10)
    res_t = trunner.run_scenario(tt, tm, tg, n_frames=10)
    jm.suppress_observations = tm.suppress_observations = True
    sj, st = res_j.state, res_t.state
    sig_j, sig_t = [], []
    for f in range(10, 20):
        for m, tr, sig, side in ((jm, jt, sig_j, "j"), (tm, tt, sig_t, "t")):
            s = sj if side == "j" else st
            obs, mask = m.match_salient_points(s, f)
            npix, nm, rho, _ = m.recruit_new_salient_points(s, f, mask)
            s, stats = tr.process_frame(s, obs, mask, npix, nm, rho)
            assert int(stats.obs_count) == 0
            sig.append(float(np.trace(np.asarray(stats.cam_pos_cov))))
            if side == "j":
                sj = s
            else:
                st = s
    assert all(b > a for a, b in zip(sig_t, sig_t[1:]))
    np.testing.assert_allclose(sig_t, sig_j, rtol=1e-9)


def test_torch_format_state_and_pixel_uncertainty():
    """format_state string-equal on the same state; the predicted pixel
    uncertainty at 1e-10."""
    (jt, jm, jg), (tt, tm, tg) = make_pair(1, matcher_kw=dict(
        detection_noise_std=0.5))
    res_j = j_run_scenario(jt, jm, jg, n_frames=6)
    state_t = interop.state_from_numpy(_np(res_j.state), device="cpu")
    for n in (16, 3):
        assert (tfilter.format_state(state_t, max_landmarks=n)
                == jfilter.format_state(res_j.state, max_landmarks=n))
    h_t, S_t = tt.predicted_pixel_uncertainty(state_t)
    h_j, S_j = jt.predicted_pixel_uncertainty(res_j.state)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tt.predicted_pixels(state_t).numpy(),
                               np.asarray(jt.predicted_pixels(res_j.state)),
                               rtol=1e-12, atol=1e-10)


def test_torch_init_tracker_state_and_orientation_error():
    (jt, _, jg), (tt, _, tg) = make_pair(1)
    from surikatoko_tpu.world.runner import (
        camera_orientation_error_deg, init_tracker_state_from_gt)
    sj = init_tracker_state_from_gt(jt, jg)
    st = trunner.init_tracker_state_from_gt(tt, tg)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-14)
    assert st.x.dtype == torch.float64 and st.x.device.type == "cpu"
    cam = np.asarray(sj.x[:13]) + np.r_[np.zeros(3), [0.0, 0.01, -0.02, 0.005],
                                        np.zeros(6)]
    for f in (0, 7):
        want = camera_orientation_error_deg(cam, JSE3(jg.R[f], jg.t[f]))
        got = trunner.camera_orientation_error_deg(
            torch.as_tensor(cam), TSE3(tg.R[f], tg.t[f]))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_torch_filter_rejects_unknown_impl():
    (_, _, _), (tt, _, _) = make_pair(1)
    with pytest.raises(ValueError, match="update_impl"):
        tfilter.MonoSlamFilter(tt.params, capacity=8, update_impl=5)
    assert tfilter.UPDATE_IMPLS == jfilter.UPDATE_IMPLS
    assert tfilter.FrameStats._fields == jfilter.FrameStats._fields
