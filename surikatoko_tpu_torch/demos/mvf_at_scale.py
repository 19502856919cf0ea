"""At-scale incremental multi-view factorization: 10k+ landmarks, 500+
keyframes, driven through the factorizer's per-frame pipeline (reference
multi-view-factorization.cpp:255-397) with the banded sparse Schur BA.

Port of ``demos/demo_mvf_at_scale.py``. The synthetic world is a ring of
landmarks orbited once by the camera, tracks frame-local and NON-wrapping:
the chain stays open and visual-odometry drift accumulates, like a real
monocular run. A short REVISIT segment then re-enters the start region,
re-detecting the head landmarks as new tracks. Place recognition pairs them
with the originals by appearance alone: the head frames and the revisit are
rendered (a textured background and one splat per landmark), their tracks
described by steered BRIEF, matched by mutual-NN Hamming distance and
verified by a similarity RANSAC over the drifted map
(vision/place_recognition.py); ``--oracle_pairs`` takes the GT pairs
instead. The accumulated Sim(3) loop error closes through the pose graph
(MultiViewFactorizer.close_loop_sim3) before the final global BA.

Per frame: matcher writes corners -> anchor selection -> SVD-12 relative
motion + GN-PnP polish -> batched MASKS-8.44 triangulation of new tracks.
Sliding-window local BA runs every ``window_ba_every`` frames; bucket-padded
global BA every ``global_ba_every`` frames. The frames and the closure run
through the pipeline's per-frame entry point, ``models.mvf.session``.

    python -m surikatoko_tpu_torch.demos.mvf_at_scale [--points 10000]
        [--frames 500] [--track_len 12] [--oracle_pairs]
        [--pr_ransac_thresh 0.25] [--device cuda] [--dtype float32]

prints one JSON line of :func:`run_at_scale`'s metrics.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom import se3
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.ba import SparseBundleAdjustment, TermCriteria
from surikatoko_tpu_torch.models.ba import sparse as ba_sparse
from surikatoko_tpu_torch.demos.multi_view_factorization import (
    ate, camera_positions)
from surikatoko_tpu_torch.models.mvf import TrackStore
from surikatoko_tpu_torch.models.mvf.session import MvfSession

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])


def make_args(**overrides) -> argparse.Namespace:
    """Default parameter set of the at-scale run as a namespace (the JAX
    demo's, with the device and dtype of the port's runs)."""
    base = dict(points=10_000, frames=500, track_len=12, noise_pix=0.5,
                window_ba_every=5, window=25, global_ba_every=25,
                global_ba_iters=10, final_polish_iters=40,
                revisit_frames=12, oracle_pairs=False,
                pr_ransac_thresh=0.25, ba_iters=5, seed=0, device="cuda",
                dtype=None)
    base.update(overrides)
    return argparse.Namespace(**base)


class World:
    """The at-scale world, drawn from ``default_rng(seed)`` in the JAX
    demo's order (points, then the landmarks' splat appearance and the
    background of the rendered frames, then each frame's detection noise as
    the frame is written), so both packages see the same points, noise and
    pixels. Host float64.

    Without the oracle pairs, writing a head frame (the first
    ``n_head_frames``) or a revisit frame also renders it and keeps (image,
    keypoints, track ids) in ``head_obs`` / ``tail_obs`` for place
    recognition (the revisit's re-detections only); ``render_s`` sums the
    rendering's host seconds."""

    def __init__(self, args):
        self.rng = rng = np.random.default_rng(args.seed)
        n_pts, n_base, L = args.points, args.frames, args.track_len
        self.n_pts, self.n_base, self.L = n_pts, n_base, L
        self.n_total = n_base + args.revisit_frames
        self.noise_pix = args.noise_pix
        # ---- noisy cylinder of points, camera ring facing inward ----
        ang = rng.uniform(0, 2 * np.pi, n_pts)
        rad = 2.0 + rng.normal(scale=0.3, size=n_pts)
        z = rng.uniform(0, 3.0, n_pts)
        self.pts_gt = np.stack([rad * np.cos(ang), rad * np.sin(ang), z],
                               axis=1)
        a = 2 * np.pi * (np.arange(self.n_total) % n_base) / n_base
        eye = np.stack([8.0 * np.cos(a), 8.0 * np.sin(a),
                        np.full(self.n_total, 1.5)], axis=1)
        t64 = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                        dtype=torch.float64)
        cfw = se3.look_at_luf_wfc(
            t64(eye), t64(np.broadcast_to([0.0, 0, 1.5], eye.shape)),
            t64(np.broadcast_to([0.0, 0, 1], eye.shape))).inv()
        self.Rs, self.ts_gt = cfw.R.numpy(), cfw.t.numpy()
        # base orbit: point i seen in frames facing[i]..facing[i]+L-1, NO
        # wrap; the revisit re-detects head landmarks as NEW track ids
        self.facing = facing = (ang / (2 * np.pi) * n_base).astype(int)
        self.frame_pts = [[] for _ in range(self.n_total)]
        for i in range(n_pts):
            for k in range(L):
                f = facing[i] + k
                if f < n_base:
                    self.frame_pts[f].append(i)
        for f in range(n_base, self.n_total):
            fm = f % n_base
            for i in np.nonzero((fm - facing) % n_base < L)[0]:
                self.frame_pts[f].append(int(i))
        # world appearance: every landmark's splat brightness and width,
        # and a smoothed textured background
        self.amps = rng.uniform(80.0, 200.0, n_pts)
        self.sigmas = rng.uniform(1.6, 2.6, n_pts)
        bg = rng.uniform(20.0, 60.0, size=(480, 640))
        self.bg_img = (bg + np.roll(bg, 1, 0) + np.roll(bg, 1, 1)
                       + np.roll(bg, -1, 0) + np.roll(bg, -1, 1)) / 5.0
        self.collect_pr = bool(args.revisit_frames) and not args.oracle_pairs
        self.n_head_frames = min(12, max(6, args.revisit_frames))
        self.head_obs, self.tail_obs = [], []
        self.render_s = 0.0

    def render_frame_np(self, ids, pix_true, ok) -> np.ndarray:
        """640x480 frame: the textured background + one splat per landmark
        at its TRUE projection (detection noise perturbs keypoints, not
        photons), as the separable contraction Ey^T diag(a) Ex: one [H,K] @
        [K,W] product over all splats (JAX demo_mvf_at_scale.py:175-194)."""
        H, W = self.bg_img.shape
        ids = np.asarray(ids, int)
        vis = (np.asarray(ok, bool)
               & (pix_true[:, 0] >= 0) & (pix_true[:, 0] < W)
               & (pix_true[:, 1] >= 0) & (pix_true[:, 1] < H))
        s2 = 2.0 * self.sigmas[ids % self.n_pts] ** 2                # [K]
        xs = np.arange(W)[None, :]
        ys = np.arange(H)[None, :]
        ex = np.exp(-(xs - pix_true[:, 0:1]) ** 2 / s2[:, None])     # [K,W]
        ey = np.exp(-(ys - pix_true[:, 1:2]) ** 2 / s2[:, None])     # [K,H]
        a = self.amps[ids % self.n_pts] * vis
        img = self.bg_img + (ey * a[:, None]).T @ ex
        return np.clip(img, 0, 255)

    def write_corners(self, ts: TrackStore, f: int) -> None:
        """Frame ``f``'s noisy corners into the track store (the revisit's
        head-region landmarks as new track ids), and a head or revisit
        frame's observations for place recognition (JAX :196-225)."""
        n_pts, n_base = self.n_pts, self.n_base
        ids = np.asarray(self.frame_pts[f], int)
        xc = self.pts_gt[ids] @ self.Rs[f].T + self.ts_gt[f]
        ok = xc[:, 2] > 0.5
        ph = xc @ K.T
        pix_true = ph[:, :2] / ph[:, 2:3]
        pix = pix_true + self.rng.normal(scale=self.noise_pix,
                                         size=(len(ids), 2))
        head = self.facing[ids] < n_base // 2
        K_inv = np.linalg.inv(K)
        kept = []           # (tid_w, noisy pixel) of every written corner
        for tid, p, o, hd in zip(ids, pix, ok, head):
            if o:
                tid_w = int(tid) + n_pts if (f >= n_base and hd) else int(tid)
                ts.add_corner(tid_w, f, p, K_inv)
                kept.append((tid_w, p))
        if self.collect_pr and (f < self.n_head_frames or f >= n_base):
            if f >= n_base:     # the revisit group: the re-detections only
                kept = [(t, p) for t, p in kept if t >= n_pts]
            if kept:
                t0 = time.perf_counter()
                img = self.render_frame_np(ids, pix_true, ok)
                self.render_s += time.perf_counter() - t0
                (self.tail_obs if f >= n_base else self.head_obs).append(
                    (img, np.stack([p for _, p in kept]),
                     [t for t, _ in kept]))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _median(xs) -> float | None:
    return float(np.median(xs)) if len(xs) else None


def run_at_scale(args: argparse.Namespace, *, profile_frame: int | None = None,
                 profiler=None) -> dict:
    """The at-scale incremental MVF pipeline on ``args.device`` (the card by
    default) in ``args.dtype`` (default ``config.default_dtype(device)``);
    returns the JAX demo's metrics dict (demo_mvf_at_scale.py:407-428) with
    unrounded numbers, plus the trajectory ATE right after the closure, the
    BA profile (per-run build/compute/readback seconds), each stage's
    (frame, wall seconds) of every frame (``stage_s``), the per-run
    medians, every BA's (kind, ok, stop reason, iterations, trials), the
    final BA's stop reasons and errors, and the band plan of the final BA
    (the port's ``_plan`` geometry in place of the JAX demo's band
    signature). Without the oracle pairs it also returns the place
    recognition's counts and stage times (``place_recognition``: render,
    describe, match and RANSAC host ms, each stage synchronized).

    At frame ``profile_frame`` each stage that runs (``"integrate"``,
    ``"window_ba"``, ``"global_ba"``) runs as ``profiler(stage, fn)``,
    which must call ``fn()`` once and return its result: a caller's
    profiler or counter sees that frame's work alone. Place recognition
    runs a second time, unsynchronized, as
    ``profiler("place_recognition", fn)`` (outside ``closure_s``)."""
    device = torch.device(args.device)
    dtype = args.dtype or config.default_dtype(device)
    world = World(args)
    n_pts, n_base, n_frames = world.n_pts, world.n_base, world.n_total
    ts = TrackStore(max_tracks=2 * n_pts, max_frames=n_frames,
                    max_track_len=2 * args.track_len)
    sess = MvfSession(
        ts, K, base_frames=n_base, window=args.window,
        window_ba_every=args.window_ba_every,
        global_ba_every=args.global_ba_every,
        global_ba_iters=args.global_ba_iters, point_bucket=2048,
        frame_bucket=100, pr_ransac_thresh=args.pr_ransac_thresh,
        device=device, dtype=dtype)
    mvf = sess.mvf

    t_int0 = time.perf_counter()
    ba_time = 0.0
    stage_s = {"integrate": [], "window_ba": [], "global_ba": []}
    for f in range(n_frames):
        def stage(name, fn):
            nonlocal ba_time
            t0 = time.perf_counter()
            if f == profile_frame and profiler is not None:
                out = profiler(name, fn)
            else:
                out = fn()
            dt = time.perf_counter() - t0
            stage_s[name].append((f, dt))
            if name != "integrate":
                ba_time += dt
            return out

        world.write_corners(ts, f)
        if f < 2:
            tids = ts.tracks_in_frame(f)
            sess.known_frame(SE3(world.Rs[f], world.ts_gt[f]), tids,
                             world.pts_gt[tids])
            continue
        sess.frame(f, stage)
    _sync(device)
    t_integrate = time.perf_counter() - t_int0 - ba_time
    fps = (n_frames - 2) / t_integrate

    # ---- Sim(3) loop closure from the revisit's re-detected landmarks ----
    pos_gt = camera_positions(world.Rs, world.ts_gt)

    def traj_ate():
        return ate(camera_positions(mvf.cam_cfw_R, mvf.cam_cfw_t), pos_gt)

    ate_pre_closure = traj_ate()
    ate_post_closure = pr_stats = None
    closed, n_pairs, n_correct, closure_s = False, 0, -1, 0.0
    if args.revisit_frames:
        tb = time.perf_counter()
        if args.oracle_pairs:
            closed, pairs, _ = sess.close(
                pairs=[(n_pts + i, i) for i in range(n_pts)])
        else:
            pairs, pr_stats = sess.loop_pairs(world.head_obs, world.tail_obs,
                                              sync=_sync)
            pr_stats["stage_ms"]["render_ms"] = 1e3 * world.render_s
            n_correct = sum(1 for a, b in pairs if a - n_pts == b)
            if profiler is not None:
                # on the same map as the run it profiles: before the closure
                tp = time.perf_counter()
                profiler("place_recognition", lambda: sess.loop_pairs(
                    world.head_obs, world.tail_obs))
                tb += time.perf_counter() - tp
            closed, pairs, _ = sess.close(pairs=pairs)
        n_pairs = len(pairs)
        closure_s = time.perf_counter() - tb
        ate_post_closure = traj_ate()

    # timed final BA with a fixed iteration budget (the iters/s headline)
    term = TermCriteria(allowed_reproj_err_rel_change=None,
                        max_iters=args.ba_iters)
    tids, p = mvf._sparse_problem(pad_points=8)
    ba = SparseBundleAdjustment(optimize_intrinsics=False,
                                point_chunk=mvf.ba_point_chunk,
                                unity_comp_ind=mvf._unity_comp_ind(),
                                device_loop=True)
    ba.set_plan_inputs(*mvf._last_sparse_inputs)
    err_before = float(ba_sparse.reproj_error(p))
    t0 = time.perf_counter()
    ok, p_opt = ba.compute_inplace(p, term)
    _sync(device)
    t_first = time.perf_counter() - t0
    plan = ba._plan
    # two warm reps with the points moved a little, keep the best
    t_reps = []
    for r in (1, 2):
        t0 = time.perf_counter()
        ok, p_opt = ba.compute_inplace(
            p._replace(points=p.points * (1.0 + r * 1e-6)), term)
        _sync(device)
        t_reps.append(time.perf_counter() - t0)
    t_ba = min(t_reps)
    n_timed, n_trials, stop_timed = ba.iterations, ba.trials, ba.stop_reason
    iters_per_s = n_timed / max(t_ba, 1e-9)

    # convergence polish for the reported accuracy (not timed as headline)
    polish = None
    if args.final_polish_iters:
        ok, p_opt = ba.compute_inplace(p_opt, TermCriteria(
            allowed_reproj_err_rel_change=None,
            max_iters=args.final_polish_iters))
        polish = {"ok": bool(ok), "iters": ba.iterations,
                  "trials": ba.trials, "stop": ba.stop_reason}
    err_after = float(ba_sparse.reproj_error(p_opt))

    # read back (one packed copy) + report
    flat = torch.cat([p_opt.points.reshape(-1), p_opt.cfw_R.reshape(-1),
                      p_opt.cfw_t.reshape(-1)]).cpu().numpy()
    n_p, n_f = p_opt.points.shape[0], p_opt.cfw_R.shape[0]
    pts_np = flat[:3 * n_p].reshape(n_p, 3)
    R_o = flat[3 * n_p:3 * n_p + 9 * n_f].reshape(n_f, 3, 3)
    t_o = flat[3 * n_p + 9 * n_f:].reshape(n_f, 3)
    for i, t in enumerate(tids):
        mvf.point_coords[t] = pts_np[i]
    for f in range(n_frames):
        mvf.cam_cfw_R[f], mvf.cam_cfw_t[f] = R_o[f], t_o[f]

    tids_m = sorted(mvf.point_coords)
    est = np.stack([mvf.point_coords[t] for t in tids_m])
    phys = np.asarray(tids_m) % n_pts       # revisit re-detections alias
    map_ate = ate(est, world.pts_gt[phys])
    traj_ate_final = traj_ate()

    # end-to-end throughput: denominator = TOTAL pipeline wall-clock incl.
    # the windowed/global BA (the reference's per-frame cost includes its
    # triggered BA, multi-view-factorization.cpp:378-394). The steady-state
    # variant replaces each BA run's cost with the run-cost median; failed
    # BA runs never reach per_run, their time is carried at face value
    fps_e2e = (n_frames - 2) / (t_integrate + ba_time)
    ba_steady = profiled = 0.0
    medians = {}
    for nm in ("window_ba", "global_ba"):
        pr = mvf.profile.get(nm, {}).get("per_run")
        per = sorted(sum(r[:3]) for r in pr) if pr else []
        medians[nm] = _median(per)
        if per:
            ba_steady += per[len(per) // 2] * len(per)
            profiled += sum(per)
    ba_steady += max(ba_time - profiled, 0.0)
    fps_e2e_steady = (n_frames - 2) / (t_integrate + ba_steady)
    return {
        "metric": "mvf_at_scale_ba_iters_per_s", "value": iters_per_s,
        "unit": "iters/s",
        "frames_per_s_integration": fps,
        "frames_per_s_end_to_end": fps_e2e,
        "frames_per_s_end_to_end_steady": fps_e2e_steady,
        "ba_time_s": ba_time,
        "ba_steady_s": ba_steady,
        "ba_trials_timed": int(n_trials),
        "ba_trials_per_s": n_trials / max(t_ba, 1e-9),
        "map_ate_rmse": map_ate,
        "traj_ate_rmse": traj_ate_final,
        "traj_ate_pre_closure": ate_pre_closure,
        "traj_ate_post_closure": ate_post_closure,
        "loop_closed": bool(closed),
        "closure_pairs_total": int(n_pairs),
        "closure_pairs_correct": int(n_correct),  # -1: oracle pairs
        "closure_inliers": int(mvf.last_closure_inliers),
        "closure_oracle_free": bool(args.revisit_frames
                                    and not args.oracle_pairs),
        "place_recognition": pr_stats,
        "closure_s": closure_s,
        "localization_failures": int(sess.failures),
        "points": len(tids_m), "frames": n_frames,
        "integration_s": t_integrate,
        "stage_s": stage_s,
        "ba_runs": mvf.ba_runs,
        "window_ba_median_s": medians["window_ba"],
        "global_ba_median_s": medians["global_ba"],
        "ba_profile": mvf.profile, "ba_log": list(mvf.ba_log),
        "final_ba": {"iters_timed": int(n_timed), "stop_timed": stop_timed,
                     "first_call_s": t_first, "warm_reps_s": t_reps,
                     "polish": polish, "err_before": err_before,
                     "err_after": err_after},
        "band_plan": None if plan is None else {
            "band_width": plan.band_width,
            "banded_chunks": plan.n_banded_chunks,
            "point_chunk": plan.point_chunk,
            "overflow_chunk": plan.overflow_chunk},
        "device": str(device), "dtype": str(dtype)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=10_000)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--track_len", type=int, default=12)
    ap.add_argument("--noise_pix", type=float, default=0.5)
    ap.add_argument("--window_ba_every", type=int, default=5,
                    help="sliding-window local BA cadence (frames)")
    ap.add_argument("--window", type=int, default=25)
    ap.add_argument("--global_ba_every", type=int, default=25,
                    help="periodic global sparse BA cadence (frames)")
    ap.add_argument("--global_ba_iters", type=int, default=10)
    ap.add_argument("--final_polish_iters", type=int, default=40)
    ap.add_argument("--revisit_frames", type=int, default=12)
    ap.add_argument("--oracle_pairs", action="store_true",
                    help="close the loop on the GT pairs instead of place "
                         "recognition's")
    ap.add_argument("--pr_ransac_thresh", type=float, default=0.25,
                    help="similarity-RANSAC inlier threshold (map units) "
                         "of place recognition's pairs")
    ap.add_argument("--ba_iters", type=int, default=5,
                    help="LM iterations of the timed final global BA")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    args = ap.parse_args()
    args.dtype = getattr(torch, args.dtype) if args.dtype else None
    config.set_full_precision()
    res = run_at_scale(args)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("ba_profile", "stage_s")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
