"""The ported host image perception against the JAX package, in float64
filter state on the CPU: the NCC matcher (ImageTemplCornersMatcher), the
KLT matcher, run_image_sequence and run_image_sequence_pipelined, and the
tracker log's gate telemetry.

Tolerances: a per-call match from the same state, frame and template store
(carried by interop.matcher_store_from_numpy) gives equal best centres,
matches and gate telemetry, and corr within rtol 1e-4 / atol 1e-5 (both
search surfaces are float32, summed in other orders). Whole runs on
tests/test_imageseq.py's 10-frame 160x120 world compare frame by frame:
obs, new and deleted counts and new slots equal, cam_state within 1e-9 for
the NCC matcher; the KLT matcher's float32 flow differs from XLA's by
rounding (test_torch_klt.py: points within 1e-4 px), so its cam_state is
held to KLT_CAM_TOL. The port's pipelined loop equals its sequential loop
bit for bit. Also the two faults of the JAX matcher that the port does not
copy (ROADMAP C.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.geom.se3 import SE3 as JSE3
from surikatoko_tpu.models.monoslam import MonoSlamFilter as JFilter
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.vision import matcher as jmatcher
from surikatoko_tpu.world import scene_gen as jscene
from surikatoko_tpu.world import runner as jrunner
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.io.tracker_log import (
    TrackerInternalsLogger, read_tracker_internals)
from surikatoko_tpu_torch.models.monoslam import filter as tfilter
from surikatoko_tpu_torch.vision import matcher as tmatcher
from surikatoko_tpu_torch.world import runner as trunner

from test_imageseq import render_world
from test_vision import render_blobs

torch.set_num_threads(2)
CAM_TOL = 1e-9
KLT_CAM_TOL = 1e-6
CORR_RTOL, CORR_ATOL = 1e-4, 1e-5
MATCHERS = {"ncc": (jmatcher.ImageTemplCornersMatcher,
                    tmatcher.ImageTemplCornersMatcher),
            "klt": (jmatcher.KltCornersMatcher, tmatcher.KltCornersMatcher)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _imageseq_world(n_frames=10):
    """tests/test_imageseq.py:86's world, camera, parameters and frames."""
    wb = jscene.WorldBounds(0.0, 0.6, 0.0, 0.6, 0.0, 0.6001)
    points_world = np.asarray(
        jscene.generate_grid_points(wb, (0.5, 0.5, 0.5), 0.3))
    center = np.array([0.3, 0.3, 0.3])
    gt_cfw_world = jscene.oscillate_right_and_left(
        center + np.array([0, -1.5, 0]), center, (0, 0, 1),
        max_deviation=0.3, periods_count=1, shots_per_period=60,
        const_view_dir=True)
    gt_cfw = jrunner.gt_poses_in_tracker_frame(gt_cfw_world)
    tfw = JSE3(gt_cfw_world.R[0], gt_cfw_world.t[0])
    pts = np.asarray(points_world @ np.asarray(tfw.R).T + np.asarray(tfw.t))
    cam = jcam.make_intrinsics((160, 120), (80.0, 60.0), 1.95, (0.02, 0.02))
    params = j_make_params(cam, None, dt=1.0,
                           process_noise_lin_veloc_std=0.02,
                           process_noise_ang_veloc_std=0.005,
                           measurm_noise_std_pix=1.0,
                           sal_pnt_init_inv_dist=0.6,
                           sal_pnt_init_inv_dist_std=0.6)
    images = [render_world(pts, gt_cfw, cam, f, size=(120, 160))
              for f in range(n_frames)]
    return params, images


def _matcher_kw(kind):
    kw = dict(templ_width=11, detector_max_corners=12,
              min_distance_new_to_tracked=12.0)
    if kind == "ncc":
        kw.update(search_radius=8, min_corr_coeff=0.6)
    else:
        kw.update(klt_levels=2, klt_win=5)
    return kw


def _pair(params, kind, capacity=12, **kw):
    """(JAX tracker, matcher), (port tracker, matcher) on the same params."""
    jcls, tcls = MATCHERS[kind]
    kw = kw or _matcher_kw(kind)
    jt = JFilter(params, capacity=capacity, update_impl=1)
    tt = tfilter.MonoSlamFilter(
        interop.params_from_numpy(_np(params), device="cpu"),
        capacity=capacity, update_impl=1)
    return (jt, jcls(jt, **kw)), (tt, tcls(tt, **kw))


@pytest.fixture(scope="module")
def world():
    return _imageseq_world()


@pytest.mark.parametrize("kind", ["ncc", "klt"])
def test_torch_run_image_sequence_matches_jax(world, kind):
    """run_image_sequence, both packages, frame by frame."""
    params, images = world
    (jt, jm), (tt, tm) = _pair(params, kind)
    st_j, stats_j = jrunner.run_image_sequence(jt, jm, images)
    st_t, stats_t = trunner.run_image_sequence(tt, tm, images)
    tol = CAM_TOL if kind == "ncc" else KLT_CAM_TOL
    assert len(stats_t) == len(stats_j) == len(images)
    for f, (sj, st) in enumerate(zip(stats_j, stats_t)):
        for name in ("obs_count", "new_count", "deleted_count",
                     "estimated_count"):
            assert int(getattr(st, name)) == int(getattr(sj, name)), (f, name)
        np.testing.assert_array_equal(st.new_slots.numpy(),
                                      np.asarray(sj.new_slots))
        np.testing.assert_allclose(st.cam_state.numpy(), np.asarray(sj.cam_state),
                                   rtol=0, atol=tol, err_msg=f"frame {f}")
    np.testing.assert_array_equal(tm.templ_valid, jm.templ_valid)
    np.testing.assert_array_equal(tm.templates, jm.templates)
    np.testing.assert_allclose(tm.last_center, jm.last_center, rtol=0,
                               atol=0 if kind == "ncc" else 1e-4)
    assert torch.equal(st_t.P, st_t.P.T)
    # the reference test's own checks (test_pipelined_loop_matches_sequential)
    assert int(stats_t[0].new_count) >= 4
    assert np.mean([int(s.obs_count) for s in stats_t[3:]]) >= 3
    if kind == "ncc":
        assert tm.templ_evals_window == jm.templ_evals_window
        assert tm.templ_evals_gated == jm.templ_evals_gated
        assert tm.matched_in_ellipse == jm.matched_in_ellipse


@pytest.mark.parametrize("kind", ["ncc", "klt"])
def test_torch_pipelined_loop_matches_sequential(world, kind):
    """The port's pipelined loop equals its sequential loop bit for bit
    (tests/test_imageseq.py::test_pipelined_loop_matches_sequential)."""
    params, images = world

    def run(fn):
        _, (tt, tm) = _pair(params, kind)
        return fn(tt, tm, images)

    st_seq, stats_seq = run(trunner.run_image_sequence)
    st_pipe, stats_pipe = run(trunner.run_image_sequence_pipelined)
    assert torch.equal(st_seq.x, st_pipe.x)
    assert torch.equal(st_seq.P, st_pipe.P)
    assert torch.equal(st_seq.lm_active, st_pipe.lm_active)
    assert len(stats_seq) == len(stats_pipe) == len(images)
    for a, b in zip(stats_seq, stats_pipe):
        assert int(a.obs_count) == int(b.obs_count)
        assert int(a.new_count) == int(b.new_count)
        assert torch.equal(a.cam_state, b.cam_state)
        assert torch.equal(a.new_slots, b.new_slots)
    assert int(stats_seq[0].new_count) >= 4
    assert np.mean([int(s.obs_count) for s in stats_seq[3:]]) >= 3


def _state_after(tt, tm, images, n):
    """The port's state after ``n`` frames of run_image_sequence."""
    return trunner.run_image_sequence(tt, tm, images[:n])[0]


@pytest.mark.parametrize("frame", [3, 7])
def test_torch_matcher_single_call_matches_jax(world, frame):
    """One match from the same state, frame and template store: best
    centres and matches equal, corr within rtol 1e-4 / atol 1e-5, gate
    telemetry equal; then one recruit: the same candidates."""
    from surikatoko_tpu.ops import ncc as jncc
    from surikatoko_tpu_torch.ops import ncc as tncc
    params, images = world
    (jt, jm), (tt, tm) = _pair(params, "ncc")
    st_t = _state_after(tt, tm, images, frame)
    st_j = jax.tree_util.tree_map(jnp.asarray, jt.init_state())._replace(
        **{k: jnp.asarray(getattr(st_t, k).numpy()) for k in st_t._fields})
    jm = interop.matcher_store_from_numpy(tm, type(jm)(jt, **_matcher_kw("ncc")))
    # the port's store, carried into a fresh port matcher too
    tm2 = interop.matcher_store_from_numpy(
        jm, tmatcher.ImageTemplCornersMatcher(tt, **_matcher_kw("ncc")))
    img = images[frame]
    for m in (jm, tm2):
        m.analyze_frame(img)
    obs_j, mask_j = jm.match_salient_points(st_j, frame)
    obs_t, mask_t = tm2.match_salient_points(st_t, frame)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    assert tm2.last_gate_stats == jm.last_gate_stats
    assert tm2.last_gate_stats["matched"] > 0
    # the search itself: corr and the strict-ellipse flags
    centers_j, cov_j = jt.predicted_pixel_uncertainty(st_j)
    centers_t, cov_t = tt.predicted_pixel_uncertainty(st_t)
    sj = jnp.asarray(np.linalg.inv(np.asarray(cov_j) + 1e-9 * np.eye(2)),
                     jnp.float32)
    st_inv = torch.linalg.inv_ex(cov_t + 1e-9 * torch.eye(2, dtype=cov_t.dtype))[0]
    active = tm2.templ_valid & st_t.lm_active.numpy()
    kw = dict(search_radius=8, min_corr_coeff=0.6, chi2_gate=5.991464547107979)
    rj = jncc.make_ncc_search(**kw)(
        jnp.asarray(np.asarray(img, np.float32)), jnp.asarray(centers_j, jnp.float32),
        jnp.asarray(jm.templates), jnp.asarray(active), sigma_inv=sj)
    rt = tncc.make_ncc_search(**kw)(
        torch.as_tensor(np.asarray(img, np.float32)), centers_t.float(),
        torch.as_tensor(tm2.templates), torch.as_tensor(active),
        sigma_inv=st_inv.float())
    np.testing.assert_array_equal(rt.best_center.numpy(), np.asarray(rj.best_center))
    np.testing.assert_array_equal(rt.matched.numpy(), np.asarray(rj.matched))
    np.testing.assert_array_equal(rt.n_gated.numpy(), np.asarray(rj.n_gated))
    np.testing.assert_array_equal(rt.in_ellipse.numpy(), np.asarray(rj.in_ellipse))
    fin = np.isfinite(np.asarray(rj.best_corr))
    np.testing.assert_array_equal(np.isfinite(rt.best_corr.numpy()), fin)
    np.testing.assert_allclose(rt.best_corr.numpy()[fin],
                               np.asarray(rj.best_corr)[fin],
                               rtol=CORR_RTOL, atol=CORR_ATOL)
    # recruitment from the same state: the same candidates, in order
    pix_j, nm_j = jm.recruit_new_salient_points(st_j, frame, mask_j)
    pix_t, nm_t = tm2.recruit_new_salient_points(st_t, frame, mask_t)
    np.testing.assert_array_equal(nm_t.numpy(), np.asarray(nm_j))
    np.testing.assert_array_equal(pix_t.numpy(), np.asarray(pix_j))


def test_torch_matcher_gate_stats_and_log_keys(tmp_path):
    """tests/test_vision.py:139: the matcher accumulates the gate telemetry
    and the internals JSON carries it; both packages' matchers and logs
    agree frame by frame."""
    from surikatoko_tpu.io.tracker_log import TrackerInternalsLogger as JLogger
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01))
    params = j_make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.02,
                           process_noise_ang_veloc_std=0.005)
    kw = dict(templ_width=15, search_radius=8, detector_max_corners=8)
    (jt, jm), (tt, tm) = _pair(params, "ncc", capacity=8, **kw)
    img = render_blobs(np.array([[160.0, 120.0], [80.0, 60.0], [240.0, 180.0]]))
    logs = []
    for tr, m, run_log, mod in ((jt, jm, JLogger(), jrunner),
                                (tt, tm, TrackerInternalsLogger(), trunner)):
        state = tr.init_state()
        for f in range(3):
            run_log.start_new_frame()
            m.analyze_frame(img)
            obs, obs_mask = m.match_salient_points(state, f)
            new_pix, new_mask = m.recruit_new_salient_points(state, f, obs_mask)
            state, stats = tr.process_frame(state, obs, obs_mask, new_pix,
                                            new_mask)
            m.on_landmarks_added(np.asarray(stats.new_slots),
                                 np.asarray(new_pix), state)
            m.sync_removed(state)
            run_log.record_from_stats(stats, state)
            if m.last_gate_stats:
                run_log.record_gate_stats(m.last_gate_stats)
            run_log.finish_frame()
        logs.append(run_log)
    assert tm.templ_evals_window > 0
    assert 0 < tm.templ_evals_gated <= tm.templ_evals_window
    assert tm.matched_in_ellipse > 0
    assert (tm.templ_evals_window, tm.templ_evals_gated, tm.matched_in_ellipse) == (
        jm.templ_evals_window, jm.templ_evals_gated, jm.matched_in_ellipse)
    paths = [str(tmp_path / f"internals_{i}.json") for i in range(2)]
    for run_log, path in zip(logs, paths):
        run_log.write_json(path)
    doc_j, doc = (read_tracker_internals(p) for p in paths)
    rec = [fr for fr in doc["Frames"] if "TemplEvalsWindow" in fr]
    assert rec, "gate telemetry missing from internals JSON"
    assert rec[-1]["TemplEvalsGated"] <= rec[-1]["TemplEvalsWindow"]
    assert rec[-1]["MatchedInEllipse"] >= 0
    assert doc["FramesCount"] == doc_j["FramesCount"] == 3
    for a, b in zip(doc["Frames"], doc_j["Frames"]):
        assert set(a) == set(b)
        for key in ("TemplEvalsWindow", "TemplEvalsGated", "MatchedInEllipse",
                    "CommonSalPnts", "NewSalPnts", "EstimatedSalPnts"):
            assert a.get(key) == b.get(key), key
        np.testing.assert_allclose(a["CamState"], b["CamState"], rtol=0,
                                   atol=CAM_TOL)
        np.testing.assert_allclose(a["SalPntUncMedian_s"], b["SalPntUncMedian_s"],
                                   rtol=1e-9)


def _cold_cache_pair():
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01))
    params = j_make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.02,
                           process_noise_ang_veloc_std=0.005)
    kw = dict(templ_width=15, search_radius=8, detector_max_corners=8,
              min_distance_new_to_tracked=5.0)
    img = render_blobs(np.array([[60.0, 60.0], [160.0, 120.0], [240.0, 180.0],
                                 [90.0, 170.0], [210.0, 70.0], [120.0, 200.0]]))
    return _pair(params, "ncc", capacity=4, **kw), img


def test_torch_recruit_without_match_uses_fresh_free_count():
    """tests/test_vision.py:268: a recruit with no match before it in the
    frame (a cold free-count cache) budgets the free slots itself; once the
    capacity is used, a fresh recruit budgets zero. Both packages alike."""
    ((jt, jm), (tt, tm)), img = _cold_cache_pair()
    results = []
    for tr, m in ((jt, jm), (tt, tm)):
        state = tr.init_state()
        m.analyze_frame(img)
        new_pix, new_mask = m.recruit_new_salient_points(state, 0,
                                                         np.zeros(4, bool))
        n = int(np.sum(np.asarray(new_mask)))
        assert 0 < n <= 4
        state, stats = tr.process_frame(state, jnp.zeros((4, 2)) if tr is jt
                                        else torch.zeros((4, 2)),
                                        jnp.zeros(4, bool) if tr is jt
                                        else torch.zeros(4, dtype=torch.bool),
                                        new_pix, new_mask)
        m.on_landmarks_added(np.asarray(stats.new_slots), m.last_new_pix_np,
                             state)
        assert int(np.sum(np.asarray(state.lm_active))) == 4
        m.analyze_frame(img)
        _, mask2 = m.recruit_new_salient_points(state, 1, np.zeros(4, bool))
        assert int(np.sum(np.asarray(mask2))) == 0
        results.append((np.asarray(new_pix), np.asarray(new_mask),
                        np.asarray(stats.new_slots)))
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)
    assert tm._n_free_cache[0] != tm.frames_analyzed   # cold in frame 2


def test_torch_free_count_cache_keyed_on_the_frame_counter():
    """ROADMAP C.3, matcher.py:186: the JAX matcher keys its free-slot cache
    on id(state), and Python reuses the ids of freed objects, so a new state
    with a recycled id takes another state's count. The port keys it on
    ``frames_analyzed``, which analyze_frame advances: within a frame the
    match stage's count serves recruitment whatever object is passed, and
    after the next analyze_frame it is never used, even for the very same
    state object."""
    ((jt, jm), (tt, tm)), img = _cold_cache_pair()
    state = tt.init_state()
    tm.analyze_frame(img)
    tm.match_salient_points(state, 0)
    assert tm._n_free_cache == (tm.frames_analyzed, 4)
    # a hit is the counter's call: an equal state in a new object takes the
    # cached count (planted as 1 to show which count was used)
    tm._n_free_cache = (tm.frames_analyzed, 1)
    _, mask = tm.recruit_new_salient_points(state._replace(), 0, None)
    assert int(mask.sum()) == 1
    # the next frame misses with the very same state object: 4 free slots
    tm.analyze_frame(img)
    _, mask = tm.recruit_new_salient_points(state, 1, None)
    assert int(mask.sum()) == 4
    # the JAX matcher, given a state whose id equals the cached one (what a
    # recycled id does), takes the stale count
    st_j = jt.init_state()
    jm.analyze_frame(img)
    jm._n_free_cache = (id(st_j), 1)
    _, mask_j = jm.recruit_new_salient_points(st_j, 0, None)
    assert int(np.sum(np.asarray(mask_j))) == 1


def test_torch_pipelined_cuts_templates_at_the_returned_new_pix(world):
    """ROADMAP C.3, runner.py:177: the JAX pipelined loop cuts templates at
    ``matcher.last_new_pix_np`` even when recruitment returned other pixels.
    A matcher whose recruits are moved by (+2, -1) px after recruitment (its
    own host copy left as it was): the port cuts at the moved pixels, JAX at
    the stale copy."""
    params, images = world
    shift = np.array([2.0, -1.0])

    def moved(cls, move):
        class Moved(cls):
            def recruit_new_salient_points(self, state, f, obs_mask):
                new_pix, new_mask = super().recruit_new_salient_points(
                    state, f, obs_mask)
                return move(new_pix, new_mask), new_mask
        return Moved

    kw = _matcher_kw("ncc")
    jt = JFilter(params, capacity=12, update_impl=1)
    tt = tfilter.MonoSlamFilter(
        interop.params_from_numpy(_np(params), device="cpu"), capacity=12,
        update_impl=1)
    jm = moved(jmatcher.ImageTemplCornersMatcher,
               lambda p, m: p + m[:, None] * jnp.asarray(shift))(jt, **kw)
    tm = moved(tmatcher.ImageTemplCornersMatcher,
               lambda p, m: p + m[:, None] * torch.as_tensor(shift))(tt, **kw)
    ref = tmatcher.ImageTemplCornersMatcher(tt, **kw)
    img = images[0]
    _, stats_t = trunner.run_image_sequence_pipelined(tt, tm, images[:1])
    _, stats_j = jrunner.run_image_sequence_pipelined(jt, jm, images[:1])
    slots = stats_t[0].new_slots.numpy()
    np.testing.assert_array_equal(slots, np.asarray(stats_j[0].new_slots))
    assert (slots >= 0).sum() >= 4
    # the port's templates: cut at the returned (moved) pixels
    ref.analyze_frame(img)
    pix = tm.last_new_pix_np + (slots >= 0)[:, None] * shift
    ref.on_landmarks_added(slots, pix, None)
    np.testing.assert_array_equal(tm.templates, ref.templates)
    np.testing.assert_array_equal(tm.last_center, ref.last_center)
    # JAX's: at the recruits before the move
    ref2 = tmatcher.ImageTemplCornersMatcher(tt, **kw)
    ref2.analyze_frame(img)
    ref2.on_landmarks_added(slots, jm.last_new_pix_np, None)
    np.testing.assert_array_equal(jm.templates, ref2.templates)
    assert not np.array_equal(tm.templates, jm.templates)
