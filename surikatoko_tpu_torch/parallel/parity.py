"""The sharded paths held to the single-device ones on a group of ranks.

:func:`sharded_parity` runs on every rank of a process group (a one-rank
NCCL group on one card, n cards, or gloo ranks on the CPU):

(a) the sharded fused step at K = ``capacity`` in float64 and float32
    against ``fused_step.fused_update_health_predict`` on the same inputs
    (``dryrun.make_problem``): x and P max |diff|, P == P^T bit for bit, and
    this rank's two row slabs of the frame's downdate (the camera rows and
    its own rows, kernel B2's row-slab form) equal to those rows of the full
    B2 call; then the sharded fused loop's ms a frame;
(b) the sharded imageseq runner with bench.py:355-358's settings (the wide
    world of ``n_points`` splats, templates of 15, ``recruit_max`` 12, 64
    detector corners, the local depth prior) over ``frames`` against
    ``make_imageseq_scan_runner`` on the same state:
    ``sharded_pallas_matched_absdiff`` (bench.py's name, limit 5) and
    ``sharded_pos_maxdiff``, the kernels' launches (on a card one B1 and two
    B2-slab launches a frame, no full B2), then ``timed`` frames (fps);
(c) the banded point-sharded sparse BA at ``ba_size``: the first trial's
    du and dX against the full-width single-device solve (relative 2-norm,
    ``BAND_RTOL``), and two LM iterations of the group's
    ``SparseBundleAdjustment`` lowering the error with the plan engaged.

Every check is a bool under ``checks``. On n ranks, with the dry run's body
on the same ranks after it:

    python -m surikatoko_tpu_torch.parallel.parity --ranks 4 [--device cuda]
        [--out FILE]

prints rank 0's metrics as one JSON line (also appended to ``--out``), with
``ranks_agree``: every rank's P checksums equal.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom import camera
from surikatoko_tpu_torch.models.ba import SparseBundleAdjustment, TermCriteria
from surikatoko_tpu_torch.models.ba import sparse as sp
from surikatoko_tpu_torch.models.monoslam import fused_step
from surikatoko_tpu_torch.models.monoslam.state import (CAM_STATE_COMPS,
                                                        init_state, make_params)
from surikatoko_tpu_torch.ops import covariance, ncc_cuda
from surikatoko_tpu_torch.parallel import dryrun, launch
from surikatoko_tpu_torch.parallel import sharded_ekf as se
from surikatoko_tpu_torch.parallel.sharded_imageseq import (
    make_sharded_imageseq_runner)
from surikatoko_tpu_torch.parallel.sharded_schur import (
    make_sharded_sparse_schur_solver)
from surikatoko_tpu_torch.world.ba_scene import build_at_scale_problem
from surikatoko_tpu_torch.world.device_runner import (
    build_imageseq_scenario, init_imageseq, make_imageseq_scan_runner)

# bench.py:355-358's imageseq settings
IMAGESEQ_KW = dict(templ_width=15, recruit=True, recruit_max=12,
                   detector_corners=64, recruit_depth="local")
# bench.py's limit on the matched-count difference to the single device
MATCHED_ABSDIFF_MAX = 5
# the fused step's x against the single device's, by type; P likewise in
# float32, relative to max |P| (float64 P is held equal on a card)
X_TOL = {torch.float64: 1e-9, torch.float32: 1e-3}
P_REL_TOL_F32 = 1e-6
# frames of the sharded fused loop timed, after LOOP_WARM
LOOP_FRAMES, LOOP_WARM = 20, 2


def flagship_world(capacity: int, device, n_points: int = 1024):
    """(params, scenario) of the flagship imageseq run: 640x480, the wide
    world of ``n_points`` splats, ``capacity`` slots, in the device's
    default type."""
    dtype = config.default_dtype(device)
    cam = camera.make_intrinsics((640, 480), (320.0, 240.0), 1.95,
                                 (0.005, 0.005), dtype=dtype, device=device)
    params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         sal_pnt_init_inv_dist=0.5,
                         sal_pnt_init_inv_dist_std=0.5,
                         max_undetected_frames=30, covar_diag_inflation=1e-6,
                         dtype=dtype, device=device)
    sc = build_imageseq_scenario(capacity, dtype=dtype, image_size=(640, 480),
                                 n_points=n_points, bg_cell=48,
                                 max_deviation=0.8, world="wide",
                                 device=device)
    return params, sc


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fused(group, device, capacity: int, dtype) -> tuple[dict, dict]:
    """(a) in one type: (metrics, checks)."""
    params, st, obs, mask = dryrun.make_problem(capacity, device, dtype)
    sh = se.shard_of(group, capacity)
    ref = fused_step.fused_update_health_predict(params, st.x, st.P, obs, mask)
    got = se.make_sharded_fused_step(params, capacity, group)(st.x, st.P, obs,
                                                             mask)
    _, B, keep, _, _ = fused_step._fused_update_core(params, st.x, st.P, obs,
                                                     mask, None, None)
    B = B.contiguous()
    full = covariance.symmetric_downdate(st.P, B, keep)
    slabs_equal = True
    for r0, R in ((0, CAM_STATE_COMPS), (sh.col0, 6 * sh.L)):
        slab = covariance.symmetric_downdate_rows(
            st.P[r0:r0 + R].contiguous(), B, keep, r0)
        slabs_equal &= bool(torch.equal(slab, full[r0:r0 + R]))
    p_diff = float((got[1] - ref[1]).abs().max())
    p_tol = (0.0 if dtype == torch.float64 and device.type == "cuda"
             else X_TOL[torch.float64] if dtype == torch.float64
             else P_REL_TOL_F32 * float(ref[1].abs().max()))
    loop = se.make_sharded_fused_loop(params, capacity, group)
    loop(st.x, st.P, obs.expand(LOOP_WARM, *obs.shape), mask)
    _sync(device)
    t0 = time.perf_counter()
    loop(st.x, st.P, obs.expand(LOOP_FRAMES, *obs.shape), mask)
    _sync(device)
    m = {"x_max_abs_diff": float((got[0] - ref[0]).abs().max()),
         "P_max_abs_diff": p_diff, "P_tol": p_tol,
         "P_symmetric": bool(torch.equal(got[1], got[1].T)),
         "P_equals_single_device": bool(torch.equal(got[1], ref[1])),
         "slabs_equal_full_b2": slabs_equal,
         "finite": bool(torch.isfinite(got[1]).all()),
         "P_checksum": float((got[1] * got[1]).sum()),
         "loop_ms_per_frame": 1e3 * (time.perf_counter() - t0) / LOOP_FRAMES}
    name = str(dtype).split(".")[-1]
    checks = {f"fused_{name}_symmetric": m["P_symmetric"],
              f"fused_{name}_finite": m["finite"],
              f"fused_{name}_x_close": m["x_max_abs_diff"] <= X_TOL[dtype],
              f"fused_{name}_P_close": p_diff <= p_tol,
              f"fused_{name}_slabs_equal_full_b2": slabs_equal}
    return m, checks


def _imageseq(group, device, capacity: int, n_points: int, frames, timed,
              profile) -> tuple[dict, dict]:
    """(b): (metrics, checks)."""
    params, sc = flagship_world(capacity, device, n_points)
    st, tm = init_imageseq(params, sc, init_state(
        capacity, dtype=sc.background.dtype, device=device), 15)
    run_sh = make_sharded_imageseq_runner(params, capacity, group,
                                          **IMAGESEQ_KW)
    run_1 = make_imageseq_scan_runner(params, **IMAGESEQ_KW)
    _sync(device)
    ncc_cuda.LAUNCHES = covariance.LAUNCHES = covariance.ROWS_LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_sh(st.x, st.P, tm, st.lm_active, st.lm_unobserved,
                 st.lm_generation, sc, frames)
    _sync(device)
    t_first = time.perf_counter() - t0
    launches = {"ncc_search": ncc_cuda.LAUNCHES,
                "symmetric_downdate": covariance.LAUNCHES,
                "symmetric_downdate_rows": covariance.ROWS_LAUNCHES}
    _, _, (_, n_1, pos_1, nrec_1, _, _) = run_1(st, tm, sc, frames)
    err_s, n_s, pos_s, nrec_s, nact_s, info_s = res[6]
    t0 = time.perf_counter()
    res_t = run_sh(*res[:6], sc, timed)
    _sync(device)
    dt = time.perf_counter() - t0
    m = {"K": capacity, "frames": [frames[0], frames[-1]],
         "first_run_s": t_first, "launches": launches,
         "sharded_pallas_matched_absdiff": int((n_s - n_1).abs().max()),
         "sharded_pos_maxdiff": float((pos_s - pos_1).abs().max()),
         "n_matched": n_s.tolist(), "n_matched_single": n_1.tolist(),
         "recruited": int(nrec_s.sum()), "recruited_single": int(nrec_1.sum()),
         "active_last": int(nact_s[-1]), "chol_info_max": int(info_s.max()),
         "timed_frames": [timed[0], timed[-1]], "fps": len(timed) / dt,
         "wall_ms_per_frame": 1e3 * dt / len(timed),
         "P_symmetric": bool(torch.equal(res_t[1], res_t[1].T))}
    if profile is not None:
        m["profile_frame"] = timed[-1] + 1
        m["profile"] = profile(lambda: run_sh(*res_t[:6], sc,
                                              [timed[-1] + 1]))
    nf = len(frames)
    checks = {"imageseq_finite": bool(torch.isfinite(err_s).all()
                                      and torch.isfinite(res_t[6][0]).all()),
              "imageseq_matched_absdiff_le_5":
                  m["sharded_pallas_matched_absdiff"] <= MATCHED_ABSDIFF_MAX,
              "imageseq_P_symmetric": m["P_symmetric"]}
    if device.type == "cuda":
        checks.update(
            imageseq_b1_each_frame=launches["ncc_search"] == nf,
            imageseq_slab_launched=launches["symmetric_downdate_rows"] == 2 * nf,
            imageseq_no_full_b2=launches["symmetric_downdate"] == 0)
    return m, checks


def _ba(group, device, ba_size: tuple) -> tuple[dict, dict]:
    """(c): (metrics, checks)."""
    from surikatoko_tpu_torch.demos.ba_at_scale import BAND_RTOL
    n_pts, n_fr, tl = ba_size
    n = dist.get_world_size(group)
    ps, fidx, fmask = build_at_scale_problem(
        n_pts, n_fr, tl, noise_pix=0.3, seed=0,
        dtype=config.default_dtype(device), device=device)
    blocks = sp.compute_blocks(ps)
    plan = sp.plan_bands_sharded(fidx, fmask, n, 64, n_fr)
    solve = make_sharded_sparse_schur_solver(n_pts, n_fr, tl, group,
                                             point_chunk=64, band_plan=plan)
    dX, du, ok = solve(ps, blocks, 1e-4)
    dX1, du1, ok1 = sp.solve_corrections_schur_sparse(ps, blocks, 1e-4,
                                                      point_chunk=64)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    err0 = float(sp.reproj_error(ps))
    ba = SparseBundleAdjustment(group=group, point_chunk=64, band=True)
    ba.set_plan_inputs(fidx, fmask)
    t0 = time.perf_counter()
    ok_lm, ps_opt = ba.compute(ps, TermCriteria(
        allowed_reproj_err_rel_change=None, max_iters=2))
    _sync(device)
    m = {"points": n_pts, "frames": n_fr, "track_len": tl,
         "band_width": None if plan is None else plan.band_width,
         "trial_ok": bool(ok) and bool(ok1),
         "du_rel_l2": rel(du, du1), "dX_rel_l2": rel(dX, dX1),
         "lm_ok": bool(ok_lm), "lm_s": time.perf_counter() - t0,
         "iterations": ba.iterations,
         "plan_engaged": ba._mesh_band_plan is not None,
         "err_before": err0, "err_after": float(sp.reproj_error(ps_opt))}
    checks = {"ba_trial_ok": m["trial_ok"],
              "ba_matches_single":
                  max(m["du_rel_l2"], m["dX_rel_l2"]) <= BAND_RTOL,
              "ba_lm_ok": m["lm_ok"], "ba_plan_engaged": m["plan_engaged"],
              "ba_error_decreased": m["err_after"] < m["err_before"]}
    return m, checks


def sharded_parity(group=None, device: torch.device | str = "cuda", *,
                   capacity: int = 768, n_points: int = 1024,
                   frames=range(1, 9), timed=range(9, 41),
                   ba_size: tuple = (2048, 100, 12), profile=None) -> dict:
    """(a)-(c) of the module doc on this rank of ``group`` (None: the
    world); ``profile``, if given, is called with a function that runs one
    more imageseq frame, and what it returns is kept. Returns the metrics
    with every check under ``checks``."""
    group = dist.group.WORLD if group is None else group
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = {"ranks": dist.get_world_size(group), "device": device.type,
           "backend": dist.get_backend(group), "K": capacity}
    checks = {}
    for dtype in (torch.float64, torch.float32):
        m, c = _fused(group, device, capacity, dtype)
        out[f"fused_{str(dtype).split('.')[-1]}"] = m
        checks.update(c)
    out["imageseq"], c = _imageseq(group, device, capacity, n_points,
                                   frames, timed, profile)
    checks.update(c)
    out["ba"], c = _ba(group, device, ba_size)
    checks.update(c)
    out["checks"] = checks
    return out


def _rank_body(n: int, device: str, dry: dict, **kw) -> dict:
    """One rank of :func:`main`: the parity, then the dry run's body."""
    if device == "cuda":
        config.set_full_precision()
    out = sharded_parity(device=device, **kw)
    t0 = time.perf_counter()
    out["dryrun"] = dryrun._body(n, device, **dry)
    out["dryrun"]["wall_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    outs = launch.run_ranks(_rank_body, args.ranks, args.ranks, args.device,
                            dryrun.SIZES, device=args.device)
    res = dict(outs[0], wall_s=time.perf_counter() - t0, ranks_agree=all(
        o[f"fused_{t}"]["P_checksum"] == outs[0][f"fused_{t}"]["P_checksum"]
        for o in outs for t in ("float64", "float32")))
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    bad = [k for o in outs for k, v in o["checks"].items() if not v]
    return 1 if bad or not res["ranks_agree"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
