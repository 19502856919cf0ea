"""The port's per-frame SfM step (``models.mvf.session.MvfSession``) against
the benchmark's plain reference (``benchmark/reference/sfm``: plain PyTorch
from the published methods, no code of the port), in float64 on the CPU,
on seeded worlds of the at-scale kind cut small: 600 points on the noisy
cylinder, 40 keyframes and a 6-keyframe revisit, tracks of 12, 0.5 px; a
windowed BA of 10 keyframes every 5 and a global BA every 10 (10 LM
iterations). Every step is compared from the session's own state before
it:

- each keyframe's pose and its new points, and which tracks became points;
- each windowed and each global BA (the cadence's and the one after the
  closure): its final cost and the parameters it writes back;
- the pairs that the closure hands ``close_loop_sim3``: each is a revisit
  track and the head track of the same landmark in the world;
- the LM's counters ``ba.runs``, ``ba.iterations`` and ``ba.trials``
  against the factorizer's log of the adjustments it ran;
- the factorizer's counters ``mvf.tri_tracks`` and ``mvf.loc_tracks``
  against the sizes of the batches it assembled.

And the benchmark's world (``benchmark/lib/mvf_world.py``) is the demo's
(``demos/mvf_at_scale.World``) for the same seed: corners, track ids and
the rendered head and revisit keyframes.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch.demos import mvf_at_scale
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.mvf import TrackStore
from surikatoko_tpu_torch.models.mvf import factorizer
from surikatoko_tpu_torch.models.mvf.session import MvfSession
from surikatoko_tpu_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from benchmark.lib.mvf_world import MvfWorld  # noqa: E402
from benchmark.reference.sfm import ba as ref_ba  # noqa: E402
from benchmark.reference.sfm import step as ref  # noqa: E402
from benchmark.reference.sfm.geometry import centres, rotation_angle  # noqa: E402

torch.set_num_threads(2)

SEEDS = (2147483659, 3141592653)
WORLD = dict(points=600, frames=40, revisit_frames=6)
PIPE = dict(window=10, window_ba_every=5, global_ba_every=10,
            global_ba_iters=10, point_bucket=64, frame_bucket=10,
            pr_ransac_thresh=0.25)
K_REF = torch.tensor([500.0, 500.0, 320.0, 240.0], dtype=torch.float64)
# Both sides solve the same least-squares problems in float64 to their
# optimum (the pose by 10 Gauss-Newton steps from a seed within a degree,
# the points by 5 from the linear estimate; the reference by 30 and 20):
# they meet to a few ulps of the scene's size (8 units): 5e-15 and 8e-15
# seen.
POSE_TOL = POINT_TOL = 1e-12
# The LM stops where a rejected step changes the cost by at most 32 ulps of
# it, which each side reaches after its own number of steps (4-9): the
# final costs agree to a few ulps (7e-15 relative seen); the parameters
# only to how flat the cost is along its weakest directions (a point whose
# rays are nearly parallel slides along them; 1.9e-6 of 8 units seen).
COST_REL_TOL = 1e-12
PARAM_TOL = 2e-5


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "mvf_ring10k_f500.json")) as f:
        cfg = json.load(f)
    cfg["world"].update(WORLD)
    return cfg


@pytest.fixture(scope="module", params=SEEDS)
def sfm_pass(request):
    """One pass of the session on the world of the seed, the session's
    state before each keyframe and after each of its stages, and the pairs
    its closure handed to close_loop_sim3, the candidates and shared
    tracks the factorizer assembled, the LM's and the factorizer's counters
    over the pass and the factorizer's log of its adjustments."""
    cfg = _config()
    counts0 = profiling.counts()
    assembled = {"mvf.tri_tracks": 0, "mvf.loc_tracks": 0}
    fz = factorizer.MultiViewFactorizer
    batch, loc = fz._assemble_tri_batch, fz._localization_inputs

    def batch_spy(self, cands, *a, **kw):
        assembled["mvf.tri_tracks"] += len(cands[0])
        return batch(self, cands, *a, **kw)

    def loc_spy(self, new_frame):
        out = loc(self, new_frame)
        if out is not None:
            assembled["mvf.loc_tracks"] += len(
                self.find_anchor_frame(new_frame)[1])
        return out
    spies = pytest.MonkeyPatch()
    spies.setattr(fz, "_assemble_tri_batch", batch_spy)
    spies.setattr(fz, "_localization_inputs", loc_spy)
    w = MvfWorld(cfg, request.param)
    ts = TrackStore(2 * w.n_pts, w.n_total, 2 * cfg["world"]["track_len"])
    s = MvfSession(ts, w.K, base_frames=w.n_base, device="cpu",
                   dtype=torch.float64, **PIPE)
    steps = {}
    for f in range(w.n_total):
        w.write(ts, f)
        if f < 2:
            tids = w.corners[f][0]
            s.known_frame(SE3(w.Rs[f], w.ts[f]), tids, w.points[tids])
            continue
        stages = []

        def stage(name, fn):
            out = fn()
            stages.append((name, s.state()))
            return out
        pre = s.state()
        assert s.frame(f, stage), f
        steps[f] = (pre, stages)
    handed = []
    close = factorizer.MultiViewFactorizer.close_loop_sim3

    def spy(self, *a, pairs=None, **kw):
        handed.extend(pairs)
        return close(self, *a, pairs=pairs, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(factorizer.MultiViewFactorizer, "close_loop_sim3", spy)
    try:
        closed, pairs, _ = s.close(w.head_obs, w.tail_obs)
    finally:
        mp.undo()
    before = s.state()
    s.global_ba()
    spies.undo()
    steps["closure"] = (before, [("global_ba", s.state())])
    counted = {k: v - counts0.get(k, 0) for k, v in profiling.counts().items()
               if k.startswith(("ba.", "mvf."))}
    return (w, steps, closed, pairs, handed, assembled, counted,
            list(s.mvf.ba_log))


def _poses(st, frames=None):
    R, t = st.cfw_R, st.cfw_t
    if frames is not None:
        R, t = [R[i] for i in frames], [t[i] for i in frames]
    return torch.as_tensor(np.stack(R)), torch.as_tensor(np.stack(t))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_torch_mvf_session_frames_match_reference(sfm_pass):
    w, steps, *_ = sfm_pass
    n_new = 0
    for f in range(2, w.n_total):
        pre, stages = steps[f]
        name, after = stages[0]
        assert name == "integrate"
        R, t = _poses(pre)
        R_f, t_f, new_ref = ref.integrate(K_REF, R, t, pre.points,
                                          pre.refined, w.obs, f, 0.02)
        R_p, t_p = _t(after.cfw_R[-1]), _t(after.cfw_t[-1])
        assert float(rotation_angle(R_p, R_f)) < POSE_TOL, f
        assert float(torch.linalg.norm(centres(R_p, t_p)
                                       - centres(R_f, t_f))) < POSE_TOL, f
        new = {k: v for k, v in after.points.items()
               if pre.points.get(k) is not v}
        assert new.keys() == new_ref.keys(), f
        for k in new:
            assert float(torch.linalg.norm(_t(new[k]) - new_ref[k])) \
                < POINT_TOL, (f, k)
        n_new += len(new)
    assert n_new > 500


def _written(adj, before, res):
    X = _t(np.stack([before.points[k] for k in adj.tids]))
    R, t = _poses(before, adj.frames)
    i, j = adj.point_written, adj.pose_written
    X[i], R[j], t[j] = res.X[i], res.R[j], res.t[j]
    return X, R, t


def _check_ba(w, kind, before, after) -> bool:
    """The session's adjustment ``kind`` from ``before`` to ``after``
    against the reference's; False where there was none to run."""
    R, t = _poses(before)
    adj = (ref.window_ba(K_REF, R, t, before.points, w.obs, PIPE["window"],
                         PIPE["global_ba_iters"])
           if kind == "window_ba" else
           ref.global_ba(K_REF, R, t, before.points, w.obs,
                         PIPE["global_ba_iters"]))
    if adj is None:                     # fewer frames than the window
        assert after.cfw_R[0] is before.cfw_R[0]
        return False
    want = _written(adj, before, adj.result)
    X0 = _t(np.stack([before.points[k] for k in adj.tids]))
    got = (_t(np.stack([after.points[k] for k in adj.tids])),
           ) + _poses(after, adj.frames)
    c_got = ref_ba.cost(adj.problem, *got)
    c_want = ref_ba.cost(adj.problem, *want)
    assert abs(c_got - c_want) < COST_REL_TOL * c_want
    assert c_want < ref_ba.cost(adj.problem, X0, *_poses(before, adj.frames))
    i, j = adj.point_written, adj.pose_written
    assert float(torch.linalg.norm(got[0][i] - want[0][i], dim=-1).max()) \
        < PARAM_TOL
    assert float(rotation_angle(got[1][j], want[1][j]).max()) < PARAM_TOL
    assert float(torch.linalg.norm(centres(got[1][j], got[2][j])
                                   - centres(want[1][j], want[2][j]),
                                   dim=-1).max()) < PARAM_TOL
    return True


@pytest.mark.parametrize("kind", ["window_ba", "global_ba"])
def test_torch_mvf_session_ba_matches_reference(sfm_pass, kind):
    w, steps, *_ = sfm_pass
    runs = 0
    for f, (before, stages) in steps.items():
        for name, after in stages:
            if name == kind:
                runs += _check_ba(w, kind, before, after)
            before = after
    # every 5th keyframe from the 10th, the revisit's included; every 10th
    # and the closure's
    assert runs == {"window_ba": 8, "global_ba": 5}[kind]


def test_torch_mvf_session_closure_pairs_are_ground_truth(sfm_pass):
    w, _, closed, pairs, handed, *_ = sfm_pass
    assert closed and len(handed) >= 8
    assert handed == pairs
    assert all(a - w.n_pts == b for a, b in handed)


def test_torch_mvf_session_ba_counters_match_log(sfm_pass):
    # one count a run, an accepted step and a damped solve, as the
    # factorizer logs each adjustment: windowed 8, global 5 (as above)
    *_, counted, log = sfm_pass
    assert len(log) == 13
    counted = {k: v for k, v in counted.items() if k.startswith("ba.")}
    assert counted == {"ba.runs": len(log),
                       "ba.iterations": sum(e[3] for e in log),
                       "ba.trials": sum(e[4] for e in log)}
    assert counted["ba.trials"] >= counted["ba.iterations"] > 0


def test_torch_mvf_session_assembly_counters_match_batches(sfm_pass):
    # the candidates every triangulation batch assembled (each keyframe's
    # and the closure's re-triangulation of the map) and the shared tracks
    # every localization took, summed over the pass
    *_, assembled, counted, _ = sfm_pass
    assert {k: counted[k] for k in assembled} == assembled
    assert min(assembled.values()) > 0


def test_torch_mvf_world_is_the_demos():
    seed = SEEDS[0]
    cfg = _config()
    w = MvfWorld(cfg, seed)
    args = mvf_at_scale.make_args(**WORLD, seed=seed, device="cpu")
    d = mvf_at_scale.World(args)
    np.testing.assert_allclose(w.Rs, d.Rs, rtol=0, atol=1e-14)
    np.testing.assert_allclose(w.ts, d.ts_gt, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(w.points, d.pts_gt)
    ts = TrackStore(2 * w.n_pts, w.n_total, 24)
    tw = TrackStore(2 * w.n_pts, w.n_total, 24)
    for f in range(w.n_total):
        d.write_corners(ts, f)
        w.write(tw, f)
    for name in ("fidx", "count", "pixels", "coords"):
        np.testing.assert_array_equal(getattr(tw, name), getattr(ts, name))
    assert tw._frame_tracks == ts._frame_tracks
    for mine, demo in ((w.head_obs, d.head_obs), (w.tail_obs, d.tail_obs)):
        assert len(mine) == len(demo) > 0
        for (im, kp, tid), (im_d, kp_d, tid_d) in zip(mine, demo):
            np.testing.assert_array_equal(im, im_d)
            np.testing.assert_array_equal(kp, kp_d)
            assert list(tid) == list(tid_d)
