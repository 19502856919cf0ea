"""Circle-grid BA noise recovery: a grid world seen from cameras on an arc,
points and rotations corrupted by noise, the BA recovers them; the errors
before and after.

Port of ``demos/demo_bundle_adj_circle_grid.py`` (reference
demos/demo-bundle-adj-circle-grid.cpp), with its flags:

    python -m surikatoko_tpu_torch.demos.bundle_adj_circle_grid
        [--noise_pnt 0.03] [--noise_rot 0.01] [--allowed_repr_err 2.25e-12]
        [--frames 6] [--device cuda] [--dtype float64]

prints the JAX demo's lines and, last, one JSON line of the metrics. The
JAX demo runs in float64, and so does this one unless ``--dtype`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from surikatoko_tpu_torch.geom.align import aligned_rmse
from surikatoko_tpu_torch.models.ba import (BundleAdjustment, TermCriteria,
                                            reproj_error)
from surikatoko_tpu_torch.models.ba.problem import reproj_error_pix_per_point
from surikatoko_tpu_torch.world.ba_scene import circle_grid_problem


def make_args(**overrides) -> argparse.Namespace:
    """The JAX demo's flags as a namespace, with the port's device."""
    base = dict(noise_pnt=0.03, noise_rot=0.01, allowed_repr_err=2.25e-12,
                frames=6, device="cuda", dtype=torch.float64)
    base.update(overrides)
    return argparse.Namespace(**base)


def run(args: argparse.Namespace, log=print) -> dict:
    """The host-driven BA (the JAX demo's ``BundleAdjustment()``) on the
    corrupted circle grid; returns the metrics."""
    p, gt_points, _ = circle_grid_problem(
        noise_pnt=args.noise_pnt, noise_rot=args.noise_rot,
        n_angles=args.frames, dtype=args.dtype, device=args.device)
    gt = torch.as_tensor(gt_points, dtype=torch.float64, device=p.points.device)
    log(f"frames={p.n_frames} points={p.n_points}")
    mean_err = lambda q: float(  # noqa: E731
        torch.linalg.norm(q.points.double() - gt, dim=1).mean())
    err0 = float(reproj_error(p))
    log(f"before: reproj_err={err0:.6g} "
        f"({float(reproj_error_pix_per_point(p, err0)):.4f} pix/pnt), "
        f"mean point err={mean_err(p):.5f}")
    ba = BundleAdjustment()
    t0 = time.perf_counter()
    ok, p_opt = ba.compute_inplace(
        p, TermCriteria(allowed_reproj_err_rel_change=args.allowed_repr_err))
    err1 = float(reproj_error(p_opt))
    dt = time.perf_counter() - t0
    ate = float(aligned_rmse(p_opt.points.double(), gt))
    log(f"BA ok={ok} reason='{ba.stop_reason}' iters={ba.iterations} in "
        f"{dt:.1f}s")
    log(f"after:  reproj_err={err1:.6g} "
        f"({float(reproj_error_pix_per_point(p_opt, err1)):.6f} pix/pnt), "
        f"mean point err={mean_err(p_opt):.6f} (similarity-aligned "
        f"RMSE={ate:.6f}, the gauge-fair metric)")
    return {"frames": p.n_frames, "points": p.n_points, "ok": ok,
            "stop": ba.stop_reason, "iters": ba.iterations,
            "trials": ba.trials, "s": dt, "err_initial": err0,
            "err_final": err1, "mean_point_err_initial": mean_err(p),
            "mean_point_err_final": mean_err(p_opt), "aligned_rmse": ate,
            "finite": bool(np.isfinite(err1))}


def main() -> int:
    ap = argparse.ArgumentParser()
    d = make_args()
    ap.add_argument("--noise_pnt", type=float, default=d.noise_pnt)
    ap.add_argument("--noise_rot", type=float, default=d.noise_rot)
    ap.add_argument("--allowed_repr_err", type=float, default=d.allowed_repr_err,
                    help="stop criterion (flagfile-demo-circle-grid)")
    ap.add_argument("--frames", type=int, default=d.frames)
    ap.add_argument("--device", default=d.device)
    ap.add_argument("--dtype", default="float64",
                    choices=("float32", "float64"))
    args = ap.parse_args()
    args.dtype = getattr(torch, args.dtype)
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
