"""Batch bundle adjustment: B independently corrupted circle-grid worlds
normalized, optimized and reverted as one batch.

Port of ``demos/demo_batch_ba.py``. The JAX demo vmaps its compiled
normalize -> LM -> revert program over the problems; here
``BundleAdjustment.compute_batched`` maps each step over the batch with
``torch.func.vmap`` and keeps the LM's schedule on the host, one packed
fetch of every problem's (ok, err) a trial. The per-problem matrices are
small, so batching is what gives the card work. With its flags:

    python -m surikatoko_tpu_torch.demos.batch_ba [--batch 32]
        [--noise_pnt 0.06] [--noise_rot 0.01] [--frames 6] [--max_iters 25]
        [--allowed_repr_err 1e-12] [--compare_sequential] [--f32]
        [--device cuda]

prints the JAX demo's lines and, last, one JSON line of :func:`run`'s
metrics.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from surikatoko_tpu_torch.models.ba import (BundleAdjustment, TermCriteria,
                                            reproj_error)
from surikatoko_tpu_torch.models.ba.lm_device import STOP_REASON_STR
from surikatoko_tpu_torch.interop import stack
from surikatoko_tpu_torch.world.ba_scene import circle_grid_problem


# a single-problem run's stop reason as the batch's stop code
STOP_CODE = {v: k for k, v in STOP_REASON_STR.items()}


def make_args(**overrides) -> argparse.Namespace:
    """The JAX demo's flags and defaults as a namespace, with the port's
    device."""
    base = dict(batch=32, noise_pnt=0.06, noise_rot=0.01, frames=6,
                max_iters=25, allowed_repr_err=1e-12, compare_sequential=False,
                f32=False, device="cuda")
    base.update(overrides)
    return argparse.Namespace(**base)


def problems(args: argparse.Namespace) -> list:
    """The batch: problem b is the circle grid corrupted from
    ``default_rng(b)``, as in the JAX demo."""
    dtype = torch.float32 if args.f32 else torch.float64
    return [circle_grid_problem(noise_pnt=args.noise_pnt,
                                noise_rot=args.noise_rot, n_angles=args.frames,
                                rng=np.random.default_rng(s), dtype=dtype,
                                device=args.device)[0]
            for s in range(args.batch)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(args: argparse.Namespace, log=print) -> dict:
    """One warm-up call, then the batch timed (host clock around a
    synchronised run); with ``compare_sequential`` the same problems one
    after another through ``BundleAdjustment(device_loop=True)``, the same
    program for one problem. Returns converged (err < 1e-4 e0), the median
    error reduction, the iterations' min / median / max, problems/s batched
    (and sequential), each problem's stop code, iterations and trials, the
    batch's outer and trial rounds (and, sequential, each problem's [code,
    iterations, trials] alone)."""
    probs = problems(args)
    batch = stack(probs)
    term = TermCriteria(allowed_reproj_err_rel_change=args.allowed_repr_err,
                        max_iters=args.max_iters)
    log(f"batch={args.batch} problems, each {probs[0].n_frames} frames x "
        f"{probs[0].n_points} points, dtype={batch.points.dtype}")
    ba = BundleAdjustment(device_loop=True)
    ba.compute_batched(batch, term)             # warm-up
    _sync(args.device)
    t0 = time.perf_counter()
    r = ba.compute_batched(batch, term)
    p_out, code, iters, err, trials = r[:5]
    _sync(args.device)
    dt_batch = time.perf_counter() - t0
    e0 = np.array([float(reproj_error(p)) for p in probs])
    e1 = np.asarray(err, np.float64)
    converged = int(np.sum(e1 < 1e-4 * e0))
    reduction = float(np.median(e0 / np.maximum(e1, 1e-300)))
    out = {"batch": args.batch, "frames": probs[0].n_frames,
           "points": probs[0].n_points, "dtype": str(batch.points.dtype),
           "converged": converged, "median_err_reduction": reduction,
           "iters_min_med_max": [int(np.min(iters)), float(np.median(iters)),
                                 int(np.max(iters))],
           "batched_s": dt_batch, "problems_per_s_batched": args.batch / dt_batch,
           "codes": code.tolist(), "iters": iters.tolist(),
           "trials": trials.tolist(),
           # the batch's passes: each is one set of launches for all B
           "outer_rounds": r.outer_rounds, "trial_rounds": r.trial_rounds,
           "ms_per_trial_round": 1e3 * dt_batch / r.trial_rounds,
           "finite": bool(all(torch.isfinite(x).all() for x in
                              (p_out.points, p_out.cfw_R, p_out.cfw_t)))}
    log(f"batched: {args.batch} BAs in {dt_batch * 1e3:.1f} ms "
        f"({out['problems_per_s_batched']:.1f} problems/s); converged "
        f"{converged}/{args.batch}; median err reduction {reduction:.3g}x; "
        f"iters min/med/max = {out['iters_min_med_max']}; "
        f"{r.outer_rounds} outer / {r.trial_rounds} trial rounds")
    if args.compare_sequential:
        ba.compute_inplace(probs[0], term)      # warm-up
        _sync(args.device)
        t0 = time.perf_counter()
        seq = []
        for p in probs:
            ba.compute_inplace(p, term)
            seq.append([STOP_CODE[ba.stop_reason], ba.iterations, ba.trials])
        _sync(args.device)
        dt_seq = time.perf_counter() - t0
        out.update(sequential_s=dt_seq, sequential_path=seq,
                   sequential_trials=int(sum(t for _, _, t in seq)),
                   problems_per_s_sequential=args.batch / dt_seq,
                   batch_speedup=dt_seq / dt_batch)
        log(f"sequential: {args.batch} BAs in {dt_seq * 1e3:.1f} ms "
            f"({out['problems_per_s_sequential']:.1f} problems/s) -> batch "
            f"speedup {out['batch_speedup']:.1f}x")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    d = make_args()
    ap.add_argument("--batch", type=int, default=d.batch)
    ap.add_argument("--noise_pnt", type=float, default=d.noise_pnt)
    ap.add_argument("--noise_rot", type=float, default=d.noise_rot)
    ap.add_argument("--frames", type=int, default=d.frames)
    ap.add_argument("--max_iters", type=int, default=d.max_iters)
    ap.add_argument("--allowed_repr_err", type=float, default=d.allowed_repr_err)
    ap.add_argument("--compare_sequential", action="store_true",
                    help="also time solving the problems one at a time")
    ap.add_argument("--f32", action="store_true", help="run in float32")
    ap.add_argument("--device", default=d.device)
    print(json.dumps(run(ap.parse_args())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
