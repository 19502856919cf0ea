#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
the port builds and runs its main path.

    python3 chip_smoke.py

Phases, one JSON line each:
  env      card, versions, precision flags; builds the NCC search kernel
           (csrc/ncc_search.cu) from the checkout and times the build.
  kernel   the kernel against its plain PyTorch version: random data at the
           test shapes and at the main path's (K,T,S) = (768,15,15) (idx
           exact, corr within rtol 1e-4 / atol 1e-5), then at (768,15,15)
           on patches of a rendered flagship frame (corr within the same
           tolerance, idx agreement >= 0.99 with every differing idx a tie
           within it), and both timed with CUDA events.
  flagship the churned image-sequence loop at the benchmark configuration
           (K=768 slots, 640x480, 1024-point wide world, recruitment with
           the local depth prior, delete-unobserved), float32: init, 120
           warm-up frames, 120 timed frames. Asserts finite outputs, exact
           P == P^T, one kernel launch per frame, recruitment, matched
           median >= K/2 and ATE < 0.30.
  profile  device time by kernel of one more flagship frame
           (torch.profiler), against the timed frames' wall time.
  nosync   one more frame of the flagship and of the control with torch's
           sync debug mode raising on any host synchronization: the frame
           body must stay free of them (CUDA-graph capturable).
  control  the same world without recruitment, for its ATE.
Then a line with every kernel's launches, error and times, the card's name
and power limit as nvidia-smi gives them, and the last line
{"ok": true, "device": {...}}. Any failure raises and exits nonzero; with
no CUDA device it exits 1 before printing anything on stdout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

K_FLAGSHIP = 768
# (K, T, S): the CPU tests' shapes and the main path's
TEST_SHAPES = ((8, 9, 7), (5, 17, 25), (3, 9, 11), (768, 15, 15))
RTOL, ATOL = 1e-4, 1e-5
WARM_FRAMES = range(1, 121)
TIMED_FRAMES = range(121, 241)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_case(rng, K, T, S, device):
    import torch
    P = S + T - 1
    patches = rng.uniform(0, 255, size=(K, P, P)).astype(np.float32)
    templs = rng.uniform(0, 255, size=(K, T, T)).astype(np.float32)
    gate = rng.uniform(size=(K, S, S)) < 0.7
    gate[:, S // 2, S // 2] = True
    t = lambda a: torch.as_tensor(a, device=device)
    return t(patches), t(templs), t(gate)


def compare(ncc_cuda, patches, templs, gate, with_neigh):
    """Kernel vs plain version on the same inputs: (max |corr diff| over
    finite entries, idx agreement, ok, max |neigh diff|). ``ok`` holds corr
    (and neigh) within rtol/atol where the plain corr is finite, and the
    plain gated surface at the kernel's idx within the same tolerance of the
    plain maximum, so an idx that differs can only be a tie."""
    import torch
    from surikatoko_tpu_torch.vision import templ_match
    got = ncc_cuda.ncc_surface_argmax(patches, templs, gate, with_neigh)
    want = ncc_cuda.ncc_surface_argmax_ref(patches, templs, gate, with_neigh)
    K, S, _ = gate.shape
    surf = templ_match.corr_coeff_surface(patches, templs)
    flat = torch.where(gate, surf, -torch.inf).reshape(K, S * S)
    at_got = torch.take_along_dim(flat, got[1].long()[:, None], dim=1)[:, 0]
    torch.cuda.synchronize()
    fin = torch.isfinite(want[0])
    if not torch.equal(torch.isfinite(got[0]), fin):
        raise AssertionError("kernel and plain disagree on gated-out rows")
    err = float((got[0] - want[0])[fin].abs().max()) if bool(fin.any()) else 0.0
    agree = float((got[1] == want[1]).float().mean())
    ok = (bool(torch.allclose(got[0][fin], want[0][fin], rtol=RTOL, atol=ATOL))
          and bool(torch.allclose(at_got[fin], want[0][fin], rtol=RTOL,
                                  atol=ATOL)))
    nerr = (float((got[2] - want[2]).abs().max()) if with_neigh else 0.0)
    nok = (not with_neigh) or bool(torch.allclose(got[2], want[2], rtol=RTOL,
                                                   atol=ATOL))
    return err, agree, ok and nok, nerr


def flagship_setup(device):
    import torch
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.geom import camera
    from surikatoko_tpu_torch.models.monoslam import make_params
    from surikatoko_tpu_torch.world.device_runner import build_imageseq_scenario
    dtype = config.default_dtype(device)
    cam = camera.make_intrinsics((640, 480), (320.0, 240.0), 1.95,
                                 (0.005, 0.005), dtype=dtype, device=device)
    params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         sal_pnt_init_inv_dist=0.5,
                         sal_pnt_init_inv_dist_std=0.5,
                         max_undetected_frames=30, covar_diag_inflation=1e-6,
                         dtype=dtype, device=device)
    sc = build_imageseq_scenario(K_FLAGSHIP, dtype=dtype, image_size=(640, 480),
                                 n_points=1024, bg_cell=48, max_deviation=0.8,
                                 world="wide", device=device)
    return params, sc


def flagship_patches(params, sc, state, templates):
    """The search kernel's inputs at frame 1 of the flagship run: patches
    around the predicted pixels of the bootstrap state, the templates, and
    the in-image gate."""
    import torch
    from surikatoko_tpu_torch.models.monoslam import measure
    from surikatoko_tpu_torch.ops.ncc import search_window
    from surikatoko_tpu_torch.world.device_runner import render_frame
    img = render_frame(params, sc, 1)
    h = measure.measurement_jacobians(params, state.x)[0]
    h = torch.where(torch.isfinite(h), h, 0.0)
    T = templates.shape[-1]
    half = (T - 1) // 2
    H, W = img.shape
    patches, cx, cy = search_window(img, h, T, 7)
    gate = (cx >= half) & (cx < W - half) & (cy >= half) & (cy < H - half)
    return (patches.to(torch.float32).contiguous(),
            templates.to(torch.float32).contiguous(), gate.contiguous())


def run_loop(params, sc, recruit, device):
    import torch
    from surikatoko_tpu_torch.models.monoslam import init_state
    from surikatoko_tpu_torch.world.device_runner import (
        init_imageseq, make_imageseq_scan_runner)
    kw = dict(recruit=True, recruit_max=12, detector_corners=64,
              recruit_depth="local") if recruit else {}
    run = make_imageseq_scan_runner(params, templ_width=15, **kw)
    t0 = time.perf_counter()
    st, tm = init_imageseq(params, sc,
                           init_state(K_FLAGSHIP, dtype=sc.background.dtype,
                                      device=device), 15)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    res = run(st, tm, sc, WARM_FRAMES)
    torch.cuda.synchronize()
    st_w, tm_w = res[0], (res[1] if recruit else tm)
    t0 = time.perf_counter()
    res = run(st_w, tm_w, sc, TIMED_FRAMES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return run, res, t_init, dt, tm_w


def frame_without_host_sync(run, *args) -> None:
    """Run with every synchronizing CUDA call raising (torch's detector is
    a prototype and may miss some)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    from surikatoko_tpu_torch.ops import ncc_cuda

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    config.set_full_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    t0 = time.perf_counter()
    lib_path = ncc_cuda.build()
    ncc_cuda._load()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], **config.precision_flags(),
          "kernel_build_s": time.perf_counter() - t0,
          "kernel_lib": os.path.relpath(lib_path)})

    # ---- kernel against plain ----
    rng = np.random.default_rng(0)
    cases = []
    for K, T, S in TEST_SHAPES:
        p, t, g = random_case(rng, K, T, S, device)
        for with_neigh in (False, True):
            err, agree, ok, nerr = compare(ncc_cuda, p, t, g, with_neigh)
            cases.append({"K": K, "T": T, "S": S, "with_neigh": with_neigh,
                          "max_abs_err": err, "idx_agreement": agree,
                          "neigh_max_abs_err": nerr})
            if not (ok and agree == 1.0):
                raise AssertionError(f"kernel disagrees with plain: {cases[-1]}")
    params, sc = flagship_setup(device)
    from surikatoko_tpu_torch.models.monoslam import init_state
    from surikatoko_tpu_torch.world.device_runner import init_imageseq
    st0, tm0 = init_imageseq(params, sc, init_state(
        K_FLAGSHIP, dtype=sc.background.dtype, device=device), 15)
    fp, ft, fg = flagship_patches(params, sc, st0, tm0)
    flag_err, flag_agree, flag_ok, _ = compare(ncc_cuda, fp, ft, fg, False)
    if not flag_ok:
        raise AssertionError(f"flagship corr outside rtol {RTOL} / atol "
                             f"{ATOL}, or an idx that is no tie: max |diff| "
                             f"{flag_err}")
    if flag_agree < 0.99:
        raise AssertionError(f"flagship idx agreement {flag_agree} < 0.99")
    kern = lambda: ncc_cuda.ncc_surface_argmax(fp, ft, fg)
    plain = lambda: ncc_cuda.ncc_surface_argmax_ref(fp, ft, fg)
    reps = 200
    t_plain = [cuda_ms(plain, reps)]
    t_kern = [cuda_ms(kern, reps), cuda_ms(kern, reps)]
    t_plain.append(cuda_ms(plain, reps))
    kernel_ms, plain_ms = float(np.mean(t_kern)), float(np.mean(t_plain))
    emit({"phase": "kernel", "cases": cases,
          "flagship": {"K": K_FLAGSHIP, "T": 15, "S": 15,
                       "max_abs_err": flag_err, "idx_agreement": flag_agree,
                       "kernel_ms": t_kern, "plain_ms": t_plain}})
    del st0, tm0

    # ---- flagship slice: the main path ----
    ncc_cuda.LAUNCHES = 0
    run, res, t_init, dt, _ = run_loop(params, sc, True, device)
    launches = ncc_cuda.LAUNCHES
    st2, tm2, (err, n, pos, nrec, nact, info) = res
    fr = list(TIMED_FRAMES)
    gt_pos = -torch.einsum("fji,fj->fi", sc.gt_cfw_R[fr], sc.gt_cfw_t[fr])
    ate = float(aligned_rmse(pos.double(), gt_pos.double()))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (st2.x, st2.P, err, pos))
    symmetric = bool(torch.equal(st2.P, st2.P.T))
    n_np, nact_np = n.cpu().numpy(), nact.cpu().numpy()
    flag = {"phase": "flagship", "K": K_FLAGSHIP, "D": int(st2.x.shape[0]),
            "frames_warm": len(WARM_FRAMES), "frames_timed": len(fr),
            "init_s": t_init, "timed_s": dt, "fps": len(fr) / dt,
            "ate": ate, "ate_bench_bound": 0.25, "ate_within_bench_bound":
            ate < 0.25, "matched_med": float(np.median(n_np)),
            "recruited_total": int(nrec.sum()),
            "active_med": float(np.median(nact_np)),
            "gen_max": int(st2.lm_generation.max()),
            "chol_info_nonzero": int(torch.count_nonzero(info)),
            "launches": launches, "finite": finite,
            "P_exactly_symmetric": symmetric,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(flag)
    frames_run = len(WARM_FRAMES) + len(fr)
    if not finite:
        raise AssertionError("non-finite flagship output")
    if not symmetric:
        raise AssertionError("P != P^T after the flagship run")
    if launches != frames_run:
        raise AssertionError(f"{launches} kernel launches for {frames_run} frames")
    if flag["recruited_total"] <= 0:
        raise AssertionError("no landmark was recruited")
    if flag["matched_med"] < K_FLAGSHIP / 2:
        raise AssertionError(f"matched median {flag['matched_med']} < K/2")
    if not ate < 0.30:
        raise AssertionError(f"flagship ATE {ate} >= 0.30")

    # ---- one more frame under the profiler ----
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(st2, tm2, sc, [241])
        torch.cuda.synchronize()
    # device-side events are the kernels and copies themselves; the aten
    # rows of key_averages() repeat their time, so sum these only
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": "profile", "frame": 241,
          "device_busy_us": sum(v[0] for v in kernels.values()),
          "device_launches": sum(v[1] for v in kernels.values()),
          "timed_wall_ms_per_frame": 1e3 * dt / len(fr),
          "top_kernels_us_count": [[k[:100], v[0], v[1]] for k, v in top]})
    frame_without_host_sync(run, st2, tm2, sc, [242])
    del st2, tm2, res

    # ---- no-recruit control on the same world ----
    run_c, res_c, t_init_c, dt_c, tm_c = run_loop(params, sc, False, device)
    st_c, (err_c, n_c, pos_c, info_c) = res_c
    frame_without_host_sync(run_c, st_c, tm_c, sc, [241])
    emit({"phase": "nosync", "frames": {"flagship": 242, "control": 241},
          "host_syncs": 0})
    ate_c = float(aligned_rmse(pos_c.double(), gt_pos.double()))
    emit({"phase": "control", "recruit": False, "fps": len(fr) / dt_c,
          "ate": ate_c, "ate_flagship": ate,
          "recruitment_beats_control": ate < ate_c,
          "matched_med": float(np.median(n_c.cpu().numpy())),
          "chol_info_nonzero": int(torch.count_nonzero(info_c)),
          "finite": bool(torch.isfinite(pos_c).all())})

    emit({"kernels": [{
        "name": "ncc_surface_argmax", "route": "cuda",
        "source": "surikatoko_tpu_torch/csrc/ncc_search.cu",
        "replaces": "surikatoko_tpu/ops/ncc_pallas.py:92",
        "launches": launches, "max_abs_err": flag_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
