"""Oxford dinosaur bundle adjustment: 36 projection matrices and point
tracks (or the synthetic dino stand-in if the VGG files are not there),
decomposed and triangulated, then Kanatani LM with the Schur solve; the
f0-scaled and per-point pixel error before and after, and the trajectory
and map ATE.

Port of ``demos/demo_bundle_adj_dinosaur.py`` (reference
demos/demo-bundle-adj-dinosaur.cpp), with its flags, plus the JAX bench's
dino flow (bench.py:587-623) as :func:`run_dino`:

    python -m surikatoko_tpu_torch.demos.bundle_adj_dinosaur [--testdata DIR]
        [--f0 600] [--allowed_repr_err 4.56e-8] [--max_points N]
        [--synthetic] [--synthesize_fullscale N] [--f32] [--host_loop]
        [--device cuda]

prints the JAX demo's lines and, last, one JSON line of the metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from surikatoko_tpu_torch.geom.align import aligned_rmse
from surikatoko_tpu_torch.io import dino
from surikatoko_tpu_torch.models.ba import (
    BundleAdjustment, SparseBundleAdjustment, TermCriteria, reproj_error,
    sparse)
from surikatoko_tpu_torch.models.ba.problem import reproj_error_pix_per_point

# the dino shape of the JAX bench (bench.py:591-623)
DINO_FRAMES, DINO_POINTS = 36, 4983


def dino_problem(device, dtype, n_points=DINO_POINTS):
    """The JAX bench's dino scene (bench.py:591-607): synthetic_dino_raw(36,
    n_points, vary_track_len=True) with the tracks of >= 2 views, written in
    the VGG file formats to a temporary directory and read back through the
    loader. Returns (sparse problem, frame_idx, track_mask, GT points)."""
    Ps, obs, mask, gt = dino.synthetic_dino_raw(DINO_FRAMES, n_points,
                                                vary_track_len=True)
    keep = mask.sum(axis=1) >= 2
    with tempfile.TemporaryDirectory() as td:
        dino.write_dino_files(td, Ps, obs[keep], mask[keep], gt_points=gt[keep])
        p, fidx, tmask = dino.load_dino_problem_sparse(
            td, f0=600.0, dtype=dtype, device=device)
        gt_pts = dino.load_gt_points(td)
    return p, fidx, tmask, gt_pts


def run_dino(device, dtype, n_points=DINO_POINTS):
    """bench.py:608-623: the device-loop sparse LM, full-width solve, 8
    iterations warm, 8 timed on points·(1+1e-6), then converged from the
    warm result with the reference's criterion; its map ATE against GT."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (
        lambda: None)
    p, fidx, tmask, gt = dino_problem(device, dtype, n_points)
    ba = SparseBundleAdjustment(device_loop=True, band=False, point_chunk=1024)
    ba.set_plan_inputs(fidx, tmask)
    term = TermCriteria(allowed_reproj_err_rel_change=None, max_iters=8)
    t0 = time.perf_counter()
    ok_w, p_w = ba.compute_inplace(p, term)
    sync()
    t_warm = time.perf_counter() - t0
    warm = (ok_w, ba.stop_reason, ba.iterations, ba.trials)
    p_in = p._replace(points=p.points * (1.0 + 1e-6))
    sync()
    t0 = time.perf_counter()
    ok_t, p_t = ba.compute_inplace(p_in, term)
    sync()
    dt = time.perf_counter() - t0
    timed = (ok_t, ba.stop_reason, ba.iterations, ba.trials)
    t0 = time.perf_counter()
    ok_c, p_c = ba.compute_inplace(p_w, TermCriteria(
        allowed_reproj_err_rel_change=4.56e-8, max_iters=40))
    sync()
    t_conv = time.perf_counter() - t0
    err0, err1 = float(sparse.reproj_error(p)), float(sparse.reproj_error(p_c))
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (p_t.points, p_t.cfw_t, p_c.points, p_c.cfw_R, p_c.cfw_t, p_c.K))
    ate = float(aligned_rmse(p_c.points.double(),
                             torch.as_tensor(gt, device=p_c.points.device)))
    return {"frames": p.n_frames, "points": p.n_points,
            "obs": int(tmask.sum()), "track_len": p.track_len,
            "warm": {"ok": warm[0], "stop": warm[1], "iters": warm[2],
                     "trials": warm[3], "s": t_warm},
            "timed": {"ok": timed[0], "stop": timed[1], "iters": timed[2],
                      "trials": timed[3], "s": dt},
            "iters_per_s": timed[2] / dt, "trials_per_s": timed[3] / dt,
            "converge": {"ok": ok_c, "stop": ba.stop_reason,
                         "iters": ba.iterations, "trials": ba.trials,
                         "s": t_conv},
            "err_initial": err0, "err_final": err1,
            "pix_rms_final": 600.0 * (err1 / max(int(tmask.sum()), 1)) ** 0.5,
            "map_ate": ate, "finite": finite}


def dino_ate(device):
    """Map ATE of :func:`run_dino` in float64 on ``device`` (the pin of the
    card run's float32 ATE is this on "cpu")."""
    return run_dino(device, torch.float64)["map_ate"]


def make_args(**overrides) -> argparse.Namespace:
    """The JAX demo's flags as a namespace, with the port's device."""
    base = dict(testdata=os.environ.get("SRK_TEST_DATA", "testdata"),
                f0=600.0, allowed_repr_err=4.56e-8, max_points=None,
                synthetic=False, synthesize_fullscale=None, f32=False,
                host_loop=False, device="cuda")
    base.update(overrides)
    return argparse.Namespace(**base)


def run(args: argparse.Namespace, log=print) -> dict:
    """The JAX demo's flow: the VGG files under ``args.testdata`` (written
    there first as a full-shape synthetic with ``--synthesize_fullscale``),
    or the synthetic stand-in; the dense BA, the device loop unless
    ``host_loop``; float64 unless ``f32``. Returns the metrics."""
    dtype = torch.float32 if args.f32 else torch.float64
    if args.synthesize_fullscale:
        Ps, obs, mask, gt = dino.synthetic_dino_raw(
            n_frames=DINO_FRAMES, n_points=args.synthesize_fullscale,
            vary_track_len=True)
        keep = mask.sum(axis=1) >= 2     # the loader's track filter
        pdir = dino.write_dino_files(args.testdata, Ps, obs[keep], mask[keep],
                                     gt_points=gt[keep])
        log(f"wrote full-shape real-format synthetic to {pdir}: "
            f"{int(keep.sum())} tracks x {DINO_FRAMES} frames, "
            f"{int(np.sum(~mask[keep]))} -1 holes in viff.xy")
    dino_file = os.path.join(args.testdata, "oxfvisgeom", "dinosaur",
                             "dinoPs_as_mat108x4.txt")
    if not args.synthetic and os.path.exists(dino_file):
        log(f"loading dino data from {args.testdata}")
        p = dino.load_dino_problem(args.testdata, args.f0, args.max_points,
                                   dtype=dtype, device=args.device)
        gt_points = dino.load_gt_points(args.testdata)
        if gt_points is not None and args.max_points is not None:
            gt_points = gt_points[:args.max_points]
    else:
        log("dino files not found -> synthetic dino stand-in")
        p, gt_points = dino.synthetic_dino_problem(
            n_points=args.max_points or 1024, f0=args.f0, dtype=dtype,
            device=args.device)
    log(f"frames={p.n_frames} points={p.n_points}")
    err0 = float(reproj_error(p))
    log(f"initial reproj_err={err0:.6g} nodim "
        f"({float(reproj_error_pix_per_point(p, err0)):.4f} pix/point)")
    ba = BundleAdjustment(device_loop=not args.host_loop)
    t0 = time.perf_counter()
    ok, p_opt = ba.compute_inplace(
        p, TermCriteria(allowed_reproj_err_rel_change=args.allowed_repr_err))
    err1 = float(reproj_error(p_opt))
    dt = time.perf_counter() - t0
    log(f"BA finished ok={ok} reason='{ba.stop_reason}' iters={ba.iterations} "
        f"in {dt:.1f}s ({ba.iterations / max(dt, 1e-9):.2f} iters/s)")
    log(f"final reproj_err={err1:.6g} nodim "
        f"({float(reproj_error_pix_per_point(p_opt, err1)):.4f} pix/point)")
    # the camera centres against the input calibration (real data has no GT
    # beyond it), and the map against the GT points where there are some
    centres = lambda q: -torch.einsum("fji,fj->fi", q.cfw_R, q.cfw_t).double()
    out = {"frames": p.n_frames, "points": p.n_points, "ok": ok,
           "stop": ba.stop_reason, "iters": ba.iterations,
           "trials": ba.trials, "s": dt, "err_initial": err0,
           "err_final": err1,
           "traj_ate_rmse": float(aligned_rmse(centres(p_opt), centres(p)))}
    line = f"traj_ate_rmse={out['traj_ate_rmse']:.6f} (vs input calibration)"
    if gt_points is not None:
        out["map_ate_rmse"] = float(aligned_rmse(
            p_opt.points.double(),
            torch.as_tensor(np.asarray(gt_points), device=p_opt.points.device)))
        line += f"  map_ate_rmse={out['map_ate_rmse']:.6f} (vs GT points)"
    log(line)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    d = make_args()
    ap.add_argument("--testdata", default=d.testdata)
    ap.add_argument("--f0", type=float, default=d.f0)
    ap.add_argument("--allowed_repr_err", type=float, default=d.allowed_repr_err,
                    help="reproj-err relative-change stop (flagfile-demo-dino)")
    ap.add_argument("--max_points", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthesize_fullscale", type=int, metavar="N_POINTS",
                    default=None,
                    help="write an N_POINTS-track full-shape synthetic in the "
                         "real file formats into --testdata, then load it "
                         "through the real parse path (the reference-scale "
                         "run is N_POINTS=4983)")
    ap.add_argument("--f32", action="store_true", help="run in float32")
    ap.add_argument("--host_loop", action="store_true",
                    help="host-driven LM (default: the device loop, one "
                         "packed fetch a trial)")
    ap.add_argument("--device", default=d.device)
    print(json.dumps(run(ap.parse_args())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
