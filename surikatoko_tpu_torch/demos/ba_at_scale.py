"""At-scale sparse bundle adjustment: 10k+ points x 500+ frames (the JAX
bench's BA configuration), beyond any dense-Schur reach: per-point 3x3
eliminations, a banded Gram reduction of the 10F x 10F camera system, and
its Cholesky solve.

Port of ``demos/demo_ba_at_scale.py`` with its flags (``main``), plus the
card's breakdown of it (bench.py:531-585) as :func:`run_at_scale`, which
needs a card (CUDA events and the profiler):

    python -m surikatoko_tpu_torch.demos.ba_at_scale [--points 10000]
        [--frames 500] [--track_len 12] [--iters 5] [--noise_pix 0.5]
        [--f32] [--device_loop] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from surikatoko_tpu_torch.models.ba import (SparseBundleAdjustment,
                                            TermCriteria)
from surikatoko_tpu_torch.models.ba import sparse as sp
from surikatoko_tpu_torch.models.ba.derivs import frame_var_mask
from surikatoko_tpu_torch.models.ba.schur import _damp, _fixed_var_identity
from surikatoko_tpu_torch.utils.profiling import cuda_ms, device_profile
from surikatoko_tpu_torch.world.ba_scene import build_at_scale_problem

# the JAX bench's problem (bench.py:531-585) and point chunk
AS_POINTS, AS_FRAMES, AS_TRACK_LEN, AS_CHUNK = 10_000, 500, 12, 2048
# banded and full-width corrections agree when |banded - full| <=
# BAND_RTOL * |full| in the 2-norm, for du and for dX (float32)
BAND_RTOL = 1e-3


def matmul_ceiling(device, n=4096, k=8, reps=3):
    """bench.py:516-529: a chain of k [n,n] @ [n,n] float32 products, timed
    with CUDA events: (ms, FLOP/s)."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, n, generator=g, device=device)
    b = torch.randn(n, n, generator=g, device=device)

    def chain():
        c = a
        for _ in range(k):
            c = b @ c * 1e-3
        return c
    ms = cuda_ms(chain, reps)
    return ms, 2.0 * k * n ** 3 / (ms * 1e-3)


def banded_parts(ps, blocks, hf, plan, ext, reps):
    """The banded solve's parts in ms (CUDA events): the batched 3x3 point
    Cholesky with its triangular solves, the Gram-strip reduction (the
    whole reduction less the point part), and the reduced Cholesky solve
    with the point back-substitution (it works on a copy of S, as it
    factors in place)."""
    F = ps.n_frames
    E_d = _damp(blocks.E, hf)
    G = _fixed_var_identity(_damp(blocks.G, hf),
                            frame_var_mask(F, device=E_d.device))
    Sg, red, Lch, _, Fpf_s, gp_s, fidx_s = sp._banded_reduction(
        E_d, blocks.Fpf, blocks.gp, ps.frame_idx, plan, F, ext)
    E1 = torch.cat([E_d, torch.eye(3, dtype=E_d.dtype, device=E_d.device)[None]])[ext]
    t_point = cuda_ms(lambda: sp._point_factor(E1, Fpf_s, gp_s), reps)
    t_red = cuda_ms(lambda: sp._banded_reduction(
        E_d, blocks.Fpf, blocks.gp, ps.frame_idx, plan, F, ext), reps)
    t_finish = cuda_ms(lambda: sp._finish(blocks.gf, G, Sg.clone(), red, Lch,
                                          Fpf_s, gp_s, fidx_s, F), reps)
    return {"point_cholesky": t_point, "gram_strips": t_red - t_point,
            "reduced_cholesky_and_backsub": t_finish}


def run_at_scale(device, dtype, n_points=AS_POINTS, n_frames=AS_FRAMES,
                 track_len=AS_TRACK_LEN, pc=AS_CHUNK, reps=3):
    """bench.py:531-585 on the 10k x 500 problem: compute_blocks, the
    full-width and the banded Schur solve (CUDA events), banded = full,
    and the full device-loop LM."""
    ps, fidx, mask = build_at_scale_problem(n_points, n_frames, track_len,
                                            noise_pix=0.5, seed=0, dtype=dtype,
                                            device=device)
    hf = 1e-4
    blocks = sp.compute_blocks(ps)
    plan = sp.plan_bands(fidx, mask, pc, n_frames)
    if plan is None:
        raise AssertionError("plan_bands refused the at-scale problem")
    ext = torch.as_tensor(plan.ext_idx, device=device)
    full = lambda: sp.solve_corrections_schur_sparse(ps, blocks, hf, point_chunk=pc)
    band = lambda: sp.solve_corrections_schur_banded(ps, blocks, hf, plan,
                                                     ext_idx=ext)
    dX_f, du_f, ok_f = full()
    dX_b, du_b, ok_b = band()
    dX_f2, du_f2, _ = full()
    repeat_bitwise = bool(torch.equal(du_f, du_f2) and torch.equal(dX_f, dX_f2))
    du_scale, dX_scale = float(du_f.abs().max()), float(dX_f.abs().max())
    du_err = float((du_b - du_f).abs().max())
    dX_err = float((dX_b - dX_f).abs().max())
    rel_l2 = lambda a, b: float((a - b).norm() / b.norm())
    du_rel, dX_rel = rel_l2(du_b, du_f), rel_l2(dX_b, dX_f)
    # norm-wise in the 2-norm: f32 sums S in another order in the two
    # solvers, and the reduced system's conditioning amplifies that to
    # ~1e-3 of the largest entry, so one entry's difference alone moves
    # across that bound from run to run
    agree = du_rel <= BAND_RTOL and dX_rel <= BAND_RTOL
    blocks_repeat_bitwise = all(torch.equal(a, b) for a, b in
                                zip(blocks, sp.compute_blocks(ps)))
    t_blocks = cuda_ms(lambda: sp.compute_blocks(ps), reps)
    t_full = cuda_ms(full, reps)
    t_band = cuda_ms(band, reps)
    parts = {"compute_blocks": t_blocks,
             **banded_parts(ps, blocks, hf, plan, ext, reps),
             "apply_and_error": cuda_ms(lambda: sp.reproj_error(
                 sp.apply_corrections(ps, dX_b, du_b)), reps)}
    nF = 10 * n_frames
    n_chunks = -(-n_points // pc)
    f_solve = n_chunks * 2.0 * (3 * pc) * nF ** 2 + nF ** 3 / 3.0 + 2.0 * nF ** 2
    mm_ms, ceiling = matmul_ceiling(device)

    ba = SparseBundleAdjustment(optimize_intrinsics=False, point_chunk=pc,
                                device_loop=True)
    ba.set_plan_inputs(fidx, mask)
    term = TermCriteria(allowed_reproj_err_rel_change=None, max_iters=8)
    ok_w, _ = ba.compute(ps, term)
    ps_t = ps._replace(points=ps.points * (1.0 + 1e-6))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok_t, p_t = ba.compute(ps_t, term)
    torch.cuda.synchronize()
    t_lm = time.perf_counter() - t0
    lm = {"ok": ok_t, "stop": ba.stop_reason, "iters": ba.iterations,
          "trials": ba.trials, "s": t_lm}
    err0, err1 = float(sp.reproj_error(ps_t)), float(sp.reproj_error(p_t))
    lm_repeat_bitwise = bool(torch.equal(ba.compute(ps_t, term)[1].points,
                                         p_t.points))
    one = TermCriteria(allowed_reproj_err_rel_change=None, max_iters=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ba.compute(ps_t, one)
    torch.cuda.synchronize()
    wall_one = time.perf_counter() - t0
    busy, nlaunch, top, _ = device_profile(lambda: ba.compute(ps_t, one))
    trials_one = ba.trials
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (du_f, dX_f, du_b, dX_b, p_t.points, p_t.cfw_R, p_t.cfw_t))
    return {"points": n_points, "frames": n_frames, "track_len": track_len,
            "obs": int(mask.sum()), "point_chunk": pc,
            "plan": {"band_width": plan.band_width,
                     "banded_chunks": plan.n_banded_chunks,
                     "point_chunk": plan.point_chunk,
                     "overflow_chunk": plan.overflow_chunk,
                     "overflow_chunks": (len(plan.ext_idx) - plan.n_banded_chunks
                                         * plan.point_chunk) // plan.overflow_chunk},
            "ms": {"compute_blocks": t_blocks, "schur_full": t_full,
                   "schur_banded": t_band, "matmul_chain_4096x8": mm_ms},
            "lm_trial_parts_ms": parts,
            "solve_ok": {"full": bool(ok_f), "banded": bool(ok_b)},
            "banded_vs_full": {"du_max_abs_diff": du_err, "du_max_abs": du_scale,
                               "dX_max_abs_diff": dX_err, "dX_max_abs": dX_scale,
                               "du_rel_l2": du_rel, "dX_rel_l2": dX_rel,
                               "full_repeat_du_rel_l2": rel_l2(du_f2, du_f),
                               "rtol_l2": BAND_RTOL, "agree": agree},
            "repeats_bitwise": {"compute_blocks": blocks_repeat_bitwise,
                                "schur_full": repeat_bitwise,
                                "lm_8_iters": lm_repeat_bitwise},
            "ba_solve_blocks_per_s": 1e3 / (t_band + t_blocks),
            "schur_full_flop": f_solve,
            "schur_full_flop_per_s": f_solve / (t_full * 1e-3),
            "matmul_ceiling_flop_per_s": ceiling,
            "schur_pct_of_ceiling": 100.0 * f_solve / (t_full * 1e-3) / ceiling,
            "lm": lm, "ba_iters_per_s": lm["iters"] / t_lm,
            "ba_trials_per_s": lm["trials"] / t_lm,
            "err_before": err0, "err_after": err1, "warm_ok": ok_w,
            "profile_one_iter": {"trials": trials_one,
                                 "wall_us": 1e6 * wall_one,
                                 "device_busy_us": busy,
                                 "device_launches": nlaunch,
                                 "top_kernels_us_count": top},
            "finite": finite}


def make_args(**overrides) -> argparse.Namespace:
    """The JAX demo's flags as a namespace, with the port's device."""
    base = dict(points=AS_POINTS, frames=AS_FRAMES, track_len=AS_TRACK_LEN,
                iters=5, noise_pix=0.5, f32=False, device_loop=False,
                device="cuda")
    base.update(overrides)
    return argparse.Namespace(**base)


def run(args: argparse.Namespace, log=print) -> dict:
    """The JAX demo's flow: build the problem, plan the bands, then either
    ``iters`` host-driven LM iterations (one solve and one error read each,
    the factor x10 / 10 on the outcome) or, with ``device_loop``, the whole
    device-loop LM twice (the second on points x (1 + 1e-6), timed).
    Returns the metrics."""
    dtype = torch.float32 if args.f32 else torch.float64
    sync = (torch.cuda.synchronize if torch.device(args.device).type == "cuda"
            else (lambda: None))
    ps, fidx, mask = build_at_scale_problem(args.points, args.frames,
                                            args.track_len, args.noise_pix,
                                            0, dtype=dtype, device=args.device)
    n_obs = int(mask.sum())
    log(f"points={ps.n_points} frames={ps.n_frames} obs={n_obs} reduced "
        f"system={10 * ps.n_frames}x{10 * ps.n_frames} dtype={dtype}")
    plan = sp.plan_bands(fidx, mask, AS_CHUNK, ps.n_frames)
    if plan is not None:
        log(f"banded Schur: band width {plan.band_width} of {ps.n_frames} "
            f"frames, {plan.n_banded_chunks} banded chunks")
    err0 = float(sp.reproj_error(ps))
    rms = lambda e: (e / max(n_obs, 1)) ** 0.5   # noqa: E731
    log(f"initial err={err0:.6g} ({rms(err0):.3f} pix/obs rms)")
    out = {"points": ps.n_points, "frames": ps.n_frames, "obs": n_obs,
           "banded": plan is not None, "err_initial": err0}
    if args.device_loop:
        ba = SparseBundleAdjustment(device_loop=True, point_chunk=AS_CHUNK)
        ba.set_plan_inputs(fidx, mask)
        term = TermCriteria(allowed_reproj_err_rel_change=None,
                            max_iters=args.iters)
        ba.compute(ps, term)
        sync()
        t0 = time.perf_counter()
        ok, ps1 = ba.compute(ps._replace(points=ps.points * (1.0 + 1e-6)), term)
        e1 = float(sp.reproj_error(ps1))
        dt = time.perf_counter() - t0
        log(f"{ba.iterations} LM iters in the device loop: {dt:.2f}s = "
            f"{ba.iterations / dt:.2f} iters/s (final rms {rms(e1):.4f} pix)")
        return {**out, "ok": ok, "stop": ba.stop_reason,
                "iters": ba.iterations, "trials": ba.trials, "s": dt,
                "iters_per_s": ba.iterations / dt, "err_final": e1}
    ext = None if plan is None else torch.as_tensor(plan.ext_idx,
                                                    device=args.device)

    def lm_iter(p, factor):
        b = sp.compute_blocks(p)
        if plan is not None:
            dX, du, ok = sp.solve_corrections_schur_banded(p, b, factor, plan,
                                                           ext_idx=ext)
        else:
            dX, du, ok = sp.solve_corrections_schur_sparse(
                p, b, factor, point_chunk=AS_CHUNK)
        return sp.apply_corrections(p, dX, du), ok

    factor, err = 1e-4, err0
    lm_iter(ps, factor)   # warm-up
    sync()
    t0 = time.perf_counter()
    for it in range(args.iters):
        ps_try, _ = lm_iter(ps, factor)
        e = float(sp.reproj_error(ps_try))
        if e < err:
            ps, err, factor = ps_try, e, factor / 10
        else:
            factor *= 10
        log(f"iter {it}: err={err:.6g} ({rms(err):.4f} pix rms) "
            f"factor={factor:.1e}")
    dt = time.perf_counter() - t0
    log(f"{args.iters} LM iters in {dt:.2f}s = {args.iters / dt:.2f} iters/s "
        f"(final rms {rms(err):.4f} pix)")
    return {**out, "iters": args.iters, "s": dt,
            "iters_per_s": args.iters / dt, "err_final": err}


def main() -> int:
    ap = argparse.ArgumentParser()
    d = make_args()
    ap.add_argument("--points", type=int, default=d.points)
    ap.add_argument("--frames", type=int, default=d.frames)
    ap.add_argument("--track_len", type=int, default=d.track_len)
    ap.add_argument("--iters", type=int, default=d.iters)
    ap.add_argument("--noise_pix", type=float, default=d.noise_pix)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device_loop", action="store_true",
                    help="the whole LM in the device loop (one packed fetch "
                         "a trial)")
    ap.add_argument("--device", default=d.device)
    print(json.dumps(run(ap.parse_args())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
