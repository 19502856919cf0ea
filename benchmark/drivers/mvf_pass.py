"""Traffic kind: the incremental SfM pass, one keyframe a step, closed loop.

Passes over one world (``lib/mvf_world.py``) run back to back, each a new
``MvfSession``. A step writes one keyframe's corners into the session's
track store and runs ``MvfSession.frame`` on it; the keyframe's pose and
the map are then on the host. The first two keyframes of a pass take the
world's poses and points. The pass's last step is its closure: the revisit
keyframes, each as above, then ``MvfSession.close`` (place recognition and
the Sim(3) pose graph) and one global BA.

A step fails where localization fell back to the previous pose, where the
new pose (after a BA step, any pose or point) is not finite, or where the
pass's loop did not close.

Compared with the plain reference (``reference/sfm``), each from the
program's own state before it: the sampled steps, and the window's first
global-BA step whether sampled or not. A keyframe's pose and its new
points; the adjustments the step ran: their final cost, and the
parameters they write, compared through the images they predict. Every
closure of the run, warm-up included, is held to the world's ground
truth: its share of wrong pairs; and the poses that its Sim(3) pose graph
leaves, against where the similarity that the closure measured puts them:
the revisit keyframes moved by it, the head keyframes that anchor it
where they were. The control's reading there is that of a closure that
moved no pose.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import NamedTuple

import numpy as np
import torch

from benchmark.lib import program
from benchmark.lib.cell import lower_precision, worst, worst_finite
from benchmark.lib.mvf_world import MvfWorld
from benchmark.reference.sfm import ba as ref_ba
from benchmark.reference.sfm import step as ref
from benchmark.reference.sfm.geometry import centres, project, rotation_angle


class Sample(NamedTuple):
    f: int           # the keyframe (the first revisit keyframe: a closure)
    pre: object      # the session's state before the step, or None
    stages: list     # [(stage, state after it)] in order


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        from surikatoko_tpu_torch.geom.se3 import SE3
        from surikatoko_tpu_torch.models.mvf import TrackStore
        from surikatoko_tpu_torch.models.mvf.session import MvfSession
        self.SE3, self.TrackStore, self.MvfSession = SE3, TrackStore, MvfSession
        self.cfg, self.device, self.spans = cfg, torch.device(device), spans
        self.dtype = program.dtype_of(cfg)
        self.world = MvfWorld(cfg, seed)
        self.warmup = traffic["warmup_frames"]
        self.radius = cfg["world"]["orbit_radius"]
        self.samples, self.forced, self.closures = [], [], []
        self.moves = []               # (no move, the program's) each closure
        self.work = {}
        self.steps = 0
        self.f = 0
        self._rec = None
        self._capture = False
        self._first_global = True     # the window's first global BA to come

    # ---- the pass ---------------------------------------------------------
    def _new_session(self):
        w, p = self.cfg["world"], self.cfg["pipeline"]
        self.ts = self.TrackStore(max_tracks=2 * w["points"],
                                  max_frames=self.world.n_total,
                                  max_track_len=2 * w["track_len"])
        self.sess = self.MvfSession(
            self.ts, self.world.K, base_frames=self.world.n_base,
            window=p["window"], window_ba_every=p["window_ba_every"],
            global_ba_every=p["global_ba_every"],
            global_ba_iters=p["global_ba_iters"],
            point_bucket=p["point_bucket"], frame_bucket=p["frame_bucket"],
            pr_ransac_thresh=p["pr_ransac_thresh"], device=self.device,
            dtype=self.dtype)

    def capture_next(self) -> None:
        self._capture = True

    def _stage(self, name, fn):
        out = fn()
        if self._rec is not None:
            self._rec.stages.append((name, self.sess.state()))
        return out

    def _finite(self, all_points: bool) -> bool:
        m = self.sess.mvf
        ok = (np.isfinite(m.cam_cfw_R[-1]).all()
              and np.isfinite(m.cam_cfw_t[-1]).all())
        if all_points:
            ok = ok and all(np.isfinite(np.stack(v)).all() for v in (
                m.cam_cfw_R, m.cam_cfw_t, list(m.point_coords.values())))
        return bool(ok)

    def step(self) -> tuple[int, int]:
        f, w, gb = self.f, self.world, self.cfg["pipeline"]["global_ba_every"]
        in_window = self.steps >= self.warmup
        self.steps += 1
        if f < 2:
            if f == 0:
                self._new_session()
            w.write(self.ts, f)
            tids = w.corners[f][0]
            self.sess.known_frame(self.SE3(w.Rs[f], w.ts[f]), tids,
                                  w.points[tids])
            if self._capture:
                self.samples.append(Sample(f, None, []))
            self._capture = False
            self.f += 1
            return 1, 0
        if f == w.n_base:
            return self._closure()
        first_global = in_window and self._first_global and (f + 1) % gb == 0
        self._first_global &= not first_global
        if self._capture or first_global:
            self._rec = Sample(f, self.sess.state(), [])
        w.write(self.ts, f)
        ok = self.sess.frame(f, self._stage)
        ba_step = any((f + 1) % k == 0 for k in (
            self.cfg["pipeline"]["window_ba_every"], gb))
        bad = int(not ok or not self._finite(ba_step))
        if self._capture:
            self.samples.append(self._rec)
        if first_global:        # kept, whatever the sample keeps
            self.forced.append(self._rec)
        self._rec, self._capture = None, False
        self.f += 1
        return 1, bad

    def _closure(self) -> tuple[int, int]:
        w, s = self.world, self.sess
        bad = 0
        for f in range(w.n_base, w.n_total):
            w.write(self.ts, f)
            bad += int(not s.frame(f))
        before = self._world_poses()
        closed, pairs, _ = s.close(w.head_obs, w.tail_obs)
        if closed:
            self.moves.append((self._closure_err(before, before),
                               self._closure_err(before, self._world_poses())))
        rec = Sample(w.n_base, None, []) if self._capture else None
        if rec is not None:
            rec.stages.append(("pre", s.state()))
        s.global_ba()
        if rec is not None:
            rec.stages.append(("global_ba", s.state()))
            self.samples.append(rec)
        wrong = sum(1 for a, b in pairs if a - w.n_pts != b)
        self.closures.append(wrong / len(pairs) if pairs else 1.0)
        bad += int(not closed) + int(not self._finite(True))
        self._capture = False
        self.f = 0
        return w.n_total - w.n_base, bad

    def _world_poses(self):
        """World-from-camera rotations and camera centres of the pass's
        keyframes, float64 on the host."""
        m = self.sess.mvf
        R = np.stack(m.cam_cfw_R).astype(np.float64)
        t = np.stack(m.cam_cfw_t).astype(np.float64)
        Rw = R.transpose(0, 2, 1)
        return Rw, -np.einsum("nij,nj->ni", Rw, t)

    def _closure_err(self, before, after) -> float:
        """How far the closure's poses ``after`` lie from where its measured
        similarity U (head ~ s R tail + t) puts them, given the poses
        ``before`` it: each revisit keyframe at U applied to its pose, each
        anchoring head keyframe where it was. The largest rotation angle,
        and the largest centre distance over the orbit's radius. The pose
        graph spreads the loop's discrepancy over the odometry edges at a
        tenth of the closure edges' weight, so a sound graph leaves both
        near its convergence; one that moved nothing reads U's own size."""
        from surikatoko_tpu_torch.models.mvf.session import \
            CLOSURE_HEAD_FRAMES
        s, Ru, tu = self.sess.mvf.last_closure_similarity
        (Rw0, c0), (Rw1, c1) = before, after
        tail = np.arange(self.world.n_base, len(Rw0))
        head = np.arange(CLOSURE_HEAD_FRAMES)
        want_R = np.concatenate([Ru @ Rw0[tail], Rw0[head]])
        want_c = np.concatenate([s * c0[tail] @ Ru.T + tu, c0[head]])
        got_R = np.concatenate([Rw1[tail], Rw1[head]])
        got_c = np.concatenate([c1[tail], c1[head]])
        t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
        ang = rotation_angle(t64(got_R), t64(want_R))
        dc = np.linalg.norm(got_c - want_c, axis=1)
        return max(float(ang.max()), float(dc.max()) / self.radius)

    def release(self) -> None:
        self.sess = self.ts = None

    # ---- the comparison -----------------------------------------------------
    def _ref_args(self, dtype):
        K = self.world.K
        return torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                            dtype=dtype, device=self.device)

    def _poses(self, st, dtype, frames=None):
        R, t = st.cfw_R, st.cfw_t
        if frames is not None:
            R, t = [R[i] for i in frames], [t[i] for i in frames]
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                         dtype=dtype, device=self.device)
        return as_t(np.stack(R)), as_t(np.stack(t))

    def _integrate(self, pre, f, dtype, low):
        """The reference's keyframe ``f`` from ``pre``: (R, t, {tid: X})
        or None."""
        K = self._ref_args(dtype)
        R, t = self._poses(pre, dtype)
        with low():
            out = ref.integrate(K, R, t, pre.points, pre.refined,
                                self.world.obs, f,
                                self.cfg["pipeline"]["min_parallax_ratio"])
        return out

    def _adjust(self, name, before, dtype, low):
        """The reference's adjustment ``name`` from ``before``."""
        K = self._ref_args(dtype)
        R, t = self._poses(before, dtype)
        p = self.cfg["pipeline"]
        with low():
            if name == "window_ba":
                return ref.window_ba(K, R, t, before.points, self.world.obs,
                                     p["window"], p["global_ba_iters"])
            return ref.global_ba(K, R, t, before.points, self.world.obs,
                                 p["global_ba_iters"])

    def _pose_err(self, Ra, ta, Rb, tb) -> float:
        ang = rotation_angle(Ra, Rb).max()
        dc = torch.linalg.norm(centres(Ra, ta) - centres(Rb, tb), dim=-1)
        return max(float(ang), float(dc.max()) / self.radius)

    def _integrate_readings(self, pre, got, want) -> dict:
        """``got``, ``want``: (R, t, {tid: X}) of the keyframe, or None."""
        if got is None or want is None:
            return {"bookkeeping_mismatch": int((got is None) != (want is None))}
        d64 = lambda a: torch.as_tensor(np.asarray(a.cpu() if isinstance(  # noqa: E731
            a, torch.Tensor) else a, np.float64))
        pose = self._pose_err(d64(got[0]), d64(got[1]), d64(want[0]),
                              d64(want[1]))
        both = got[2].keys() & want[2].keys()
        pt = max((float(torch.linalg.norm(d64(got[2][k]) - d64(want[2][k])))
                  for k in both), default=0.0) / self.radius
        size = lambda new: len(pre.points.keys() | new.keys())  # noqa: E731
        book = (len(got[2].keys() ^ want[2].keys())
                + abs(size(got[2]) - size(want[2])))
        return {"pose_err": pose, "point_err": pt,
                "bookkeeping_mismatch": book}

    def _written(self, adj, before, res_or_state):
        """(X, R, t) on ``adj``'s problem after it wrote back, in float64:
        from the reference's result, or from a program state."""
        X0 = np.stack([before.points[k] for k in adj.tids])
        R0, t0 = self._poses(before, torch.float64, adj.frames)
        if isinstance(res_or_state, ref_ba.Result):
            # whatever its stop: at its optimum a float64 LM may end on the
            # damping cap, which the schedule reports as a failure
            res = res_or_state
            X, R, t = (torch.as_tensor(X0, dtype=torch.float64,
                                       device=self.device), R0.clone(),
                       t0.clone())
            i = torch.as_tensor(adj.point_written, device=self.device)
            j = torch.as_tensor(adj.pose_written, device=self.device)
            X[i] = res.X[i].double()
            R[j], t[j] = res.R[j].double(), res.t[j].double()
            return X, R, t
        st = res_or_state
        X = torch.as_tensor(np.stack([st.points[k] for k in adj.tids]),
                            dtype=torch.float64, device=self.device)
        R, t = self._poses(st, torch.float64, adj.frames)
        return X, R, t

    def _ba_readings(self, adj, got, want) -> dict:
        """``got``, ``want``: (X, R, t) written back on ``adj``'s problem.
        ``ba_cost_rel``: the difference of their costs over the
        reference's. ``ba_param_err``: the parameters compared through the
        images, the largest distance in pixels between an observation's
        two predicted positions. Both adjustments fix the scale by one
        baseline (the window's first two keyframes; the first two of the
        map) and stop after at most 10 iterations with their weakest modes
        (scale, bending) unconverged, where the path of the damping sets
        the points and poses to about a percent in either precision while
        the images move by thousandths of a pixel."""
        pb = adj.problem
        pb64 = pb._replace(K=pb.K.double(), pix=pb.pix.double())
        c_got = ref_ba.cost(pb64, *got)
        c_want = ref_ba.cost(pb64, *want)
        px = [project(pb64.K, R[pb.cam], t[pb.cam], X[pb.pt])
              for X, R, t in (got, want)]
        return {"ba_cost_rel": abs(c_got - c_want) / max(c_want, 1e-300),
                "ba_param_err": float(torch.linalg.norm(px[0] - px[1],
                                                        dim=-1).max())}

    @staticmethod
    def _program_frame(before, after):
        """(R, t, {tid: X} of the points it wrote) of the keyframe that the
        program integrated between two states, or None where it failed."""
        if len(after.cfw_R) == len(before.cfw_R):
            return None
        return (after.cfw_R[-1], after.cfw_t[-1],
                {k: v for k, v in after.points.items()
                 if before.points.get(k) is not v})

    def _judge(self, program_side: bool, dtype=torch.float64, low=nullcontext):
        """One dict of readings a compared step: the program's (or, for the
        control, the reference's in ``dtype`` under ``low``) against the
        float64 reference's, each part from the program's state before
        it."""
        out = []
        for s in {id(s): s for s in self.samples + self.forced}.values():
            if not s.stages:
                continue
            r = {}
            before = s.pre
            for name, after in s.stages:
                if name == "pre":
                    pass
                elif name == "integrate":
                    want = self._integrate(before, s.f, torch.float64,
                                           nullcontext)
                    got = (self._program_frame(before, after) if program_side
                           else self._integrate(before, s.f, dtype, low))
                    r.update(self._integrate_readings(before, got, want))
                else:
                    adj = self._adjust(name, before, torch.float64,
                                       nullcontext)
                    if adj is not None:
                        want = self._written(adj, before, adj.result)
                        got = self._written(
                            adj, before, after if program_side else
                            self._adjust(name, before, dtype, low).result)
                        for k, v in self._ba_readings(adj, got,
                                                      want).items():
                            r[k] = max(r.get(k, 0.0), v)
                before = after
            out.append(r)
        return out

    def check(self) -> dict:
        out = worst(self._judge(True))
        if self.closures:
            out["closure_wrong_share"] = max(self.closures)
        if self.moves:
            out["closure_pose_err"] = max(a for _, a in self.moves)
        return out

    def control(self) -> dict:
        """The reference in the program's place, one precision lower."""
        dt, low = lower_precision(self.cfg)
        out = worst_finite(self._judge(False, dt, low))
        if self.moves:
            out["closure_pose_err"] = max(b for b, _ in self.moves)
        return out
