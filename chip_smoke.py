#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
the port builds and runs its main paths.

    python3 chip_smoke.py

Phases, one JSON line each:
  env      card, versions, precision flags, the SM clock the bounds assume;
           builds both kernels from the checkout, one nvcc each, started
           together, times the builds and shows ptxas's registers and spills.
  kernel   each kernel against its plain PyTorch version on the card.
           NCC search (csrc/ncc_search.cu): random data at the test shapes
           and at the main path's (K,T,S) = (768,15,15) (idx exact, corr
           within rtol 1e-4 / atol 1e-5), then at (768,15,15) on patches of
           a rendered flagship frame (corr within the same tolerance, idx
           agreement >= 0.99 with every differing idx a tie within it).
           Symmetric downdate (csrc/symmetric_downdate.cu): random symmetric
           P and random M at (D,m) = (43,10) ... (4621,1536) and the ragged
           (129,1), (130,7), (1000,33), without and with a 0/1 keep of ~5%
           zeros: output bitwise symmetric, two launches bitwise equal, and
           |kernel - plain| <= 1e-5 (|P| o |kk^T| + |M o k|^T |M o k|) + 1e-30.
           Both timed with CUDA events over back-to-back calls (the downdate
           also against a bare masked addmm, its one-call yardstick, and also
           over replays of a CUDA graph of the calls, which leaves out the
           host's time between launches) and by the profiler's device time,
           each beside its bound: the larger of its FMAs over the
           card's f32 rate (132 SMs x 128 lanes x clocks.max.sm) and its
           bytes (inputs read once, outputs written once) over 3.35 TB/s.
  flagship the churned image-sequence loop at the benchmark configuration
           (K=768 slots, 640x480, 1024-point wide world, recruitment with
           the local depth prior, delete-unobserved), float32: init, 120
           warm-up frames, 120 timed frames. Asserts finite outputs, exact
           P == P^T, one launch of each kernel per frame, recruitment,
           matched median >= K/2 and ATE < 0.30.
  downdate_frame  the downdate kernel against its plain version on the
           (P, B, keep) of one more flagship frame (same tolerance).
  profile  device time by kernel of one more flagship frame
           (torch.profiler), against the timed frames' wall time; kernel
           B2's share counts its row padding copy with it.
  nosync   one more frame of the flagship, the control, and scenario03
           impls 1 and 4 with torch's sync debug mode raising on any host
           synchronization: the frame bodies stay free of them.
  control  the flagship's world without recruitment, for its ATE; one
           launch of each kernel per frame.
  scenario03  the JAX bench's headline (bench.py:113-176): K=96, the GT
           matcher, update impl 1, float32. Frames 1-300 for the ATE, then
           three timed windows of 300 frames (median). Asserts finite state,
           P == P^T, Cholesky info 0 every frame, one downdate launch per
           frame, and ATE <= 2 x the port's float64 ATE + 0.02.
  impls    update impls 2, 3 and 4 on the scenario03 world for 30 frames:
           finite residuals, camera within 0.5 of GT, downdate launches 0, 0
           and 2 per frame.
  ba_dino  the JAX bench's dino BA (bench.py:587-623), float32: the 36 x
           4983 synthetic turntable written in the VGG file formats and read
           back through the loader; the device-loop sparse LM (full-width
           solve, point chunk 1024), 8 iterations warm, 8 timed, then
           converged from the warm result. Asserts finite outputs, a
           decreased error and map ATE <= 2 x the port's float64 CPU ATE.
  ba_at_scale  the 10k-point x 500-frame problem (bench.py:517-585),
           float32: compute_blocks, the full-width and the banded Schur
           solve (CUDA events), the parts of one LM trial, banded = full
           (norm-wise, BAND_RTOL), whether each repeats bit for bit, the
           Schur FLOP rate against a 4096^2 matmul chain, the device-loop LM
           (8 iterations warm, 8 timed) and one profiled LM iteration.
           Asserts finite outputs, both solves ok and a decreased error.
  Neither BA phase may launch kernel B1 or B2.
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

K_FLAGSHIP = 768
# (K, T, S): the CPU tests' shapes and the main path's
TEST_SHAPES = ((8, 9, 7), (5, 17, 25), (3, 9, 11), (768, 15, 15))
RTOL, ATOL = 1e-4, 1e-5
WARM_FRAMES = range(1, 121)
TIMED_FRAMES = range(121, 241)
# (D, m) of the downdate: tests, scenario03 (K=96), the flagship (K=768) and
# ragged edges (D past a tile edge, m not a multiple of 16)
DOWNDATE_SHAPES = ((43, 10), (256, 32), (300, 64), (589, 192), (4621, 1536),
                   (129, 1), (130, 7), (1000, 33))
DOWNDATE_TIMED = ((589, 192), (4621, 1536))
# the device kernels of one downdate call: the row padding copy (128-wide
# tiles only) and the downdate itself
DOWNDATE_DEVICE_KERNELS = ("pad_rows", "downdate_kernel")

# the published peak rate of HBM3 on an H100 SXM (bytes/s); f32 lanes per SM
HBM_BYTES_PER_S = 3.35e12
F32_LANES_PER_SM = 128

SC03_K = 96
SC03_SEED = 3
SC03_ATE_FRAMES = range(1, 301)
SC03_CHUNK = 300
SC03_IMPL_FRAMES = range(1, 31)
# The port's float64 ATE of scenario03 over frames 1-300 with the noise of
# SC03_SEED, on the CPU:
#   python3 -c "import chip_smoke as c; print(c.scenario03_ate('cpu'))"
SC03_ATE_F64 = 0.007111213050805131

# the dino shape (bench.py:591-623) and the at-scale problem (bench.py:531-585)
DINO_FRAMES, DINO_POINTS = 36, 4983
# The port's float64 map ATE of the dino phase, on the CPU:
#   python3 -c "import chip_smoke as c; print(c.dino_ate('cpu'))"
DINO_ATE_F64 = 0.00255877485559129
AS_POINTS, AS_FRAMES, AS_TRACK_LEN, AS_CHUNK = 10_000, 500, 12, 2048
# banded and full-width corrections agree when max |banded - full| <=
# BAND_RTOL * max |full| + BAND_ATOL, for du and for dX (float32)
BAND_RTOL, BAND_ATOL = 1e-3, 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, units: bool = True) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    fmt = "--format=csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", fmt],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


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


def cuda_graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Time of one call of ``fn`` by CUDA events around ``replays`` replays
    of a CUDA graph of ``reps`` calls: the device's time for the calls
    without the host's launch overhead between them."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def timed_build(mod):
    t0 = time.perf_counter()
    path = mod.build()
    return os.path.relpath(path), time.perf_counter() - t0


def device_us_per_call(fn, calls: int = 5) -> float:
    """Mean device time of one call of ``fn`` over ``calls`` calls under the
    profiler (one profiled call alone varies by tens of percent)."""
    return device_profile(lambda: [fn() for _ in range(calls)])[0] / calls


def ptxas_summary(lib) -> list:
    """ptxas's registers and spills per kernel of a library built here,
    each after the line that names its kernel."""
    return [ln.strip() for ln in lib.ptxas.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def bound_ms(fma: float, nbytes: float, fma_per_s: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the FMAs over its
    f32 FMA rate and the bytes over its memory rate, and which one it is."""
    t_ops, t_bytes = fma / fma_per_s, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def downdate_work(D: int, m: int, with_keep: bool) -> tuple[float, float]:
    """(FMAs, bytes) of the downdate: the lower triangle's D(D+1)/2 m FMAs;
    P's lower half and M (and keep) read once, the [D,D] output written."""
    return (D * (D + 1) / 2 * m,
            4.0 * (D * (D + 1) / 2 + m * D + (D if with_keep else 0) + D * D))


def ncc_work(patches, templs, gate) -> tuple[float, float]:
    """(FMAs, bytes) of the NCC search: the K S^2 T^2 products of the
    cross-correlation (window sums take O(P^2) with prefix sums); the
    inputs read once, the [K] corr and idx written."""
    K, S, _ = gate.shape
    T = templs.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (patches, templs, gate))
    return float(K * S * S * T * T), float(nbytes + 8 * K)


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


def downdate_case(D, m, with_keep, device):
    """Random symmetric PSD P [D,D], M [m,D] and a 0/1 keep of ~5% zeros."""
    import torch
    g = torch.Generator(device=device).manual_seed(D * 7 + m)
    A = torch.randn(D, D, generator=g, device=device)
    P = A @ A.T / D
    P = torch.tril(P) + torch.tril(P, -1).T
    M = 0.05 * torch.randn(m, D, generator=g, device=device)
    keep = ((torch.rand(D, generator=g, device=device) > 0.05).float()
            if with_keep else None)
    return P, M, keep


def compare_downdate(cov, P, M, keep):
    """Kernel vs plain version: (max |diff|, ok) with ok = bitwise symmetric,
    a second launch bitwise equal to the first, and |kernel - plain| <= 1e-5
    (|P| o |kk^T| + |M o k|^T |M o k|) + 1e-30, the scale the summands set
    (f32 over m terms rounds to ~sqrt(m) 6e-8)."""
    import torch
    got = cov.symmetric_downdate(P, M, keep)
    again = cov.symmetric_downdate(P, M, keep)
    want = cov.symmetric_downdate_ref(P, M, keep)
    k = torch.ones(P.shape[0], device=P.device) if keep is None else keep
    Mk = (M * k[None, :]).abs()
    bound = 1e-5 * (P.abs() * (k[:, None] * k[None, :]) + Mk.T @ Mk) + 1e-30
    diff = (got - want).abs()
    torch.cuda.synchronize()
    ok = (torch.equal(got, got.T) and torch.equal(got, again)
          and bool(torch.isfinite(got).all()) and bool((diff <= bound).all()))
    return float(diff.max()), ok


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


def flagship_downdate_inputs(params, state):
    """(P, B, keep) of the fused step at ``state``, with every active slot
    whose projection is finite taken as matched at its predicted pixel."""
    import torch
    from surikatoko_tpu_torch.models.monoslam import fused_step, measure
    h = measure.measurement_jacobians(params, state.x)[0]
    ok = torch.isfinite(h).all(dim=-1)
    obs = torch.where(ok[:, None], h, 0.0)
    _, B, keep, _, _ = fused_step._fused_update_core(
        params, state.x, state.P, obs, state.lm_active & ok, None, None)
    return state.P, B.contiguous(), keep


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


def device_profile(fn):
    """(device busy us, device launches, top kernels, {kernel: [us,
    launches]} of all) of one call of ``fn`` under torch.profiler. The
    device-side events are the kernels and copies themselves; the aten rows
    of key_averages() repeat their time, so only these are summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return (sum(v[0] for v in kernels.values()),
            sum(v[1] for v in kernels.values()),
            [[k[:100], v[0], v[1]] for k, v in top], kernels)


def downdate_share(kernels) -> list:
    """[device us, device launches] of kernel B2 in a profile: its downdate
    kernel and, at 128-wide tiles, the row padding copy launched before it
    in the same wrapper call."""
    rows = [v for k, v in kernels.items()
            if any(n in k for n in DOWNDATE_DEVICE_KERNELS)]
    return [sum(v[0] for v in rows), sum(v[1] for v in rows)]


def scenario03_setup(device, dtype):
    """The JAX bench's scenario03 (bench.py:113-127) at K=96, bootstrapped
    from GT, and its standard-normal detection noise from SC03_SEED: [96,2]
    for the bootstrap, [300,96,2] for the ATE frames, [3,300,96,2] for the
    timed windows. Returns (params, sc, state, ate_noise, timed_noise)."""
    import torch
    from surikatoko_tpu_torch.geom import camera
    from surikatoko_tpu_torch.models.monoslam import init_state, make_params
    from surikatoko_tpu_torch.world.device_runner import (
        build_oscillating_scenario, init_with_gt_landmarks)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype, device=device)
    params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype,
                         device=device)
    sc = build_oscillating_scenario(capacity=SC03_K, dtype=dtype, device=device)
    rng = np.random.default_rng(SC03_SEED)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    init_noise = t(rng.standard_normal((SC03_K, 2)))
    ate_noise = t(rng.standard_normal((len(SC03_ATE_FRAMES), SC03_K, 2)))
    timed_noise = t(rng.standard_normal((3, SC03_CHUNK, SC03_K, 2)))
    state = init_with_gt_landmarks(
        params, sc, init_state(SC03_K, dtype=dtype, device=device), init_noise)
    return params, sc, state, ate_noise, timed_noise


def gt_positions(sc, frames):
    import torch
    fr = list(frames)
    return -torch.einsum("fji,fj->fi", sc.gt_cfw_R[fr], sc.gt_cfw_t[fr])


def scenario03_ate(device="cpu", dtype=None):
    """ATE (Umeyama-aligned RMSE) of scenario03 impl 1 over frames 1-300."""
    import torch
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    from surikatoko_tpu_torch.world.device_runner import make_scan_runner
    params, sc, state, ate_noise, _ = scenario03_setup(
        device, dtype or torch.float64)
    pos = make_scan_runner(params, 1)(state, sc, SC03_ATE_FRAMES, ate_noise)[3]
    return float(aligned_rmse(pos.double(), gt_positions(sc, SC03_ATE_FRAMES).double()))


def dino_problem(device, dtype, n_points=DINO_POINTS):
    """The JAX bench's dino scene (bench.py:591-607): synthetic_dino_raw(36,
    n_points, vary_track_len=True) with the tracks of >= 2 views, written in
    the VGG file formats to a temporary directory and read back through the
    loader. Returns (sparse problem, frame_idx, track_mask, GT points)."""
    import tempfile
    from surikatoko_tpu_torch.io import dino
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
    import torch
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    from surikatoko_tpu_torch.models.ba import (SparseBundleAdjustment,
                                                TermCriteria, sparse)
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


def dino_ate(device="cpu"):
    """Map ATE of the dino phase, in float64."""
    import torch
    return run_dino(device, torch.float64)["map_ate"]


def matmul_ceiling(device, n=4096, k=8, reps=3):
    """bench.py:516-529: a chain of k [n,n] @ [n,n] float32 products, timed
    with CUDA events: (ms, FLOP/s)."""
    import torch
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
    import torch
    from surikatoko_tpu_torch.models.ba import sparse as sp
    from surikatoko_tpu_torch.models.ba.derivs import frame_var_mask
    from surikatoko_tpu_torch.models.ba.schur import _damp, _fixed_var_identity
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
    import torch
    from surikatoko_tpu_torch.models.ba import (SparseBundleAdjustment,
                                                TermCriteria, sparse as sp)
    from surikatoko_tpu_torch.world.ba_scene import build_at_scale_problem
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
    # norm-wise: f32 sums S in another order in the two solvers, and the
    # reduced system's conditioning amplifies that in its small entries
    agree = (du_err <= BAND_RTOL * du_scale + BAND_ATOL
             and dX_err <= BAND_RTOL * dX_scale + BAND_ATOL)
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
                               "rtol_of_max": BAND_RTOL, "atol": BAND_ATOL,
                               "agree": agree},
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    from surikatoko_tpu_torch.ops import covariance, ncc_cuda
    from surikatoko_tpu_torch.world.device_runner import make_scan_runner

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    config.set_full_precision()
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    fma_per_s = n_sm * F32_LANES_PER_SM * clock_mhz * 1e6
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        builds = dict(zip(("ncc_search", "symmetric_downdate"),
                          ex.map(timed_build, (ncc_cuda, covariance))))
    t_builds = time.perf_counter() - t0
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], **config.precision_flags(),
          "kernel_builds_s": {k: v[1] for k, v in builds.items()},
          "kernel_builds_wall_s": t_builds,
          "kernel_libs": {k: v[0] for k, v in builds.items()},
          "ptxas": {"ncc_search": ptxas_summary(ncc_cuda._LIB),
                    "symmetric_downdate": ptxas_summary(covariance._LIB)},
          "clocks_max_sm_mhz": clock_mhz, "sms": n_sm,
          "f32_fma_per_s": fma_per_s, "hbm_bytes_per_s": HBM_BYTES_PER_S})

    # ---- kernels against their plain versions ----
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
    ncc_bound, ncc_bound_by = bound_ms(*ncc_work(fp, ft, fg), fma_per_s)
    ncc_device_us = device_us_per_call(kern)

    dd_cases, dd_times = [], {}
    for D, m in DOWNDATE_SHAPES:
        for with_keep in (False, True):
            P, M, keep = downdate_case(D, m, with_keep, device)
            err, ok = compare_downdate(covariance, P, M, keep)
            dd_cases.append({"D": D, "m": m, "keep": with_keep,
                             "max_abs_err": err})
            if not ok:
                raise AssertionError(f"downdate kernel disagrees with plain "
                                     f"or is not symmetric: {dd_cases[-1]}")
            if with_keep and (D, m) in DOWNDATE_TIMED:
                Mk = M * keep[None, :]
                fns = {"kernel": lambda: covariance.symmetric_downdate(P, M, keep),
                       "plain": lambda: covariance.symmetric_downdate_ref(P, M, keep),
                       "addmm": lambda: torch.addmm(
                           P * (keep[:, None] * keep[None, :]), Mk.T, Mk, alpha=-1)}
                n = 200 if D < 1000 else 40
                tm = {k: [] for k in fns}
                for name in ("plain", "kernel", "addmm", "addmm", "kernel", "plain"):
                    tm[name].append(cuda_ms(fns[name], n))
                tm["graph_ms"] = {name: cuda_graph_ms(fns[name], n // 4)
                                  for name in ("plain", "kernel", "addmm")}
                b_ms, b_by = bound_ms(*downdate_work(D, m, True), fma_per_s)
                kern_ms = float(np.mean(tm["kernel"]))
                tm.update(kernel_device_us=device_us_per_call(fns["kernel"]),
                          tile=covariance.downdate_config(D)[0],
                          bound_ms=b_ms, bound_by=b_by,
                          pct_of_bound=100.0 * b_ms / kern_ms)
                dd_times[f"{D}x{m}"] = tm
    emit({"phase": "kernel",
          "ncc_search": {"cases": cases,
                         "flagship": {"K": K_FLAGSHIP, "T": 15, "S": 15,
                                      "max_abs_err": flag_err,
                                      "idx_agreement": flag_agree,
                                      "kernel_ms": t_kern, "plain_ms": t_plain,
                                      "kernel_device_us": ncc_device_us,
                                      "bound_ms": ncc_bound,
                                      "bound_by": ncc_bound_by,
                                      "pct_of_bound": 100.0 * ncc_bound / kernel_ms}},
          "symmetric_downdate": {"cases": dd_cases, "ms_with_keep": dd_times}})
    del st0, tm0

    # ---- flagship slice: the main path ----
    ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
    run, res, t_init, dt, _ = run_loop(params, sc, True, device)
    launches = {"ncc_search": ncc_cuda.LAUNCHES,
                "symmetric_downdate": covariance.LAUNCHES}
    st2, tm2, (err, n, pos, nrec, nact, info) = res
    fr = list(TIMED_FRAMES)
    gt_pos = gt_positions(sc, fr)
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
    if launches != {k: frames_run for k in launches}:
        raise AssertionError(f"kernel launches {launches} for {frames_run} frames")
    if flag["recruited_total"] <= 0:
        raise AssertionError("no landmark was recruited")
    if flag["matched_med"] < K_FLAGSHIP / 2:
        raise AssertionError(f"matched median {flag['matched_med']} < K/2")
    if not ate < 0.30:
        raise AssertionError(f"flagship ATE {ate} >= 0.30")

    # ---- the downdate kernel on one more flagship frame's inputs ----
    dd_err, dd_ok = compare_downdate(covariance,
                                     *flagship_downdate_inputs(params, st2))
    emit({"phase": "downdate_frame", "D": int(st2.x.shape[0]),
          "m": 2 * K_FLAGSHIP, "max_abs_err": dd_err, "ok": dd_ok})
    if not dd_ok:
        raise AssertionError(f"downdate kernel disagrees with plain on a "
                             f"flagship frame: max |diff| {dd_err}")

    # ---- one more frame under the profiler ----
    busy, nlaunch, top, by_kernel = device_profile(lambda: run(st2, tm2, sc, [241]))
    emit({"phase": "profile", "frame": 241, "device_busy_us": busy,
          "device_launches": nlaunch,
          "symmetric_downdate_us_launches": downdate_share(by_kernel),
          "timed_wall_ms_per_frame": 1e3 * dt / len(fr),
          "top_kernels_us_count": top})
    frame_without_host_sync(run, st2, tm2, sc, [242])
    del st2, tm2, res

    # ---- no-recruit control on the same world ----
    ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
    run_c, res_c, t_init_c, dt_c, tm_c = run_loop(params, sc, False, device)
    launches_c = {"ncc_search": ncc_cuda.LAUNCHES,
                  "symmetric_downdate": covariance.LAUNCHES}
    st_c, (err_c, n_c, pos_c, info_c) = res_c
    frame_without_host_sync(run_c, st_c, tm_c, sc, [241])
    ate_c = float(aligned_rmse(pos_c.double(), gt_pos.double()))
    emit({"phase": "control", "recruit": False, "fps": len(fr) / dt_c,
          "ate": ate_c, "ate_flagship": ate,
          "recruitment_beats_control": ate < ate_c,
          "matched_med": float(np.median(n_c.cpu().numpy())),
          "chol_info_nonzero": int(torch.count_nonzero(info_c)),
          "launches": launches_c,
          "finite": bool(torch.isfinite(pos_c).all())})
    if launches_c != {k: frames_run for k in launches_c}:
        raise AssertionError(f"control kernel launches {launches_c} for "
                             f"{frames_run} frames")
    del st_c, res_c, params, sc

    # ---- scenario03: the GT-matcher scan runner, impl 1 ----
    params3, sc3, st3_0, ate_noise, timed_noise = scenario03_setup(
        device, torch.float32)
    run3 = make_scan_runner(params3, 1)
    ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
    t0 = time.perf_counter()
    st3, errs3, n3, pos3, info3 = run3(st3_0, sc3, SC03_ATE_FRAMES, ate_noise)
    torch.cuda.synchronize()
    t_ate_run = time.perf_counter() - t0
    ate3 = float(aligned_rmse(pos3.double(),
                              gt_positions(sc3, SC03_ATE_FRAMES).double()))
    F = sc3.gt_cfw_R.shape[0]
    times, infos, finite3, sym3 = [], [info3], [], []
    for r in range(3):
        lo = 1 + ((r + 1) * SC03_CHUNK) % (F - SC03_CHUNK - 1)   # bench.py:169
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur, errs_r, _, _, info_r = run3(st3, sc3, range(lo, lo + SC03_CHUNK),
                                         timed_noise[r])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        infos.append(info_r)
        finite3.append(bool(torch.isfinite(cur.x).all()
                            and torch.isfinite(cur.P).all()
                            and torch.isfinite(errs_r).all()))
        sym3.append(bool(torch.equal(cur.P, cur.P.T)))
    launches3 = {"ncc_search": ncc_cuda.LAUNCHES,
                 "symmetric_downdate": covariance.LAUNCHES}
    frames3 = len(SC03_ATE_FRAMES) + 3 * SC03_CHUNK
    t_med = sorted(times)[1]
    busy3, nlaunch3, top3, by_kernel3 = device_profile(
        lambda: run3(st3, sc3, [301], ate_noise[:1]))
    finite3.append(bool(torch.isfinite(st3.x).all() and torch.isfinite(st3.P).all()
                        and torch.isfinite(errs3).all()))
    sym3.append(bool(torch.equal(st3.P, st3.P.T)))
    chol_bad = int(sum(int(torch.count_nonzero(i)) for i in infos))
    ate_bound = 2 * SC03_ATE_F64 + 0.02
    emit({"phase": "scenario03", "K": SC03_K, "D": int(st3.x.shape[0]),
          "update_impl": 1, "frames_ate": len(SC03_ATE_FRAMES),
          "ate_run_s": t_ate_run, "ate": ate3, "ate_f64_cpu": SC03_ATE_F64,
          "ate_bound": ate_bound,
          "matched_med": float(np.median(n3.cpu().numpy())),
          "timed_windows_s": times, "fps": SC03_CHUNK / t_med,
          "wall_ms_per_frame": 1e3 * t_med / SC03_CHUNK,
          "profile_frame": {"device_busy_us": busy3,
                            "device_launches": nlaunch3,
                            "symmetric_downdate_us_launches":
                                downdate_share(by_kernel3),
                            "top_kernels_us_count": top3},
          "chol_info_nonzero": chol_bad, "launches": launches3,
          "frames_run": frames3, "finite": all(finite3),
          "P_exactly_symmetric": all(sym3)})
    if not all(finite3):
        raise AssertionError("non-finite scenario03 state or residuals")
    if not all(sym3):
        raise AssertionError("P != P^T in scenario03")
    if chol_bad:
        raise AssertionError(f"{chol_bad} scenario03 frames lost the Cholesky")
    if launches3 != {"ncc_search": 0, "symmetric_downdate": frames3}:
        raise AssertionError(f"scenario03 kernel launches {launches3} for "
                             f"{frames3} frames")
    if not ate3 <= ate_bound:
        raise AssertionError(f"scenario03 ATE {ate3} > {ate_bound}")

    # ---- update impls 2-4 on the scenario03 world ----
    impls = {}
    gt3 = gt_positions(sc3, SC03_IMPL_FRAMES)
    noise30 = ate_noise[:len(SC03_IMPL_FRAMES)]
    for impl, per_frame in ((2, 0), (3, 0), (4, 2)):
        run_i = make_scan_runner(params3, impl)
        covariance.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_i, errs_i, n_i, pos_i, info_i = run_i(st3_0, sc3, SC03_IMPL_FRAMES,
                                                 noise30)
        torch.cuda.synchronize()
        dt_i = time.perf_counter() - t0
        impls[impl] = {"wall_ms_per_frame": 1e3 * dt_i / len(SC03_IMPL_FRAMES),
                       "max_cam_err": float((pos_i - gt3).norm(dim=-1).max()),
                       "errs_finite": bool(torch.isfinite(errs_i).all()),
                       "matched_med": float(np.median(n_i.cpu().numpy())),
                       "chol_info_nonzero": int(torch.count_nonzero(info_i)),
                       "downdate_launches": covariance.LAUNCHES}
        want = per_frame * len(SC03_IMPL_FRAMES)
        if not impls[impl]["errs_finite"]:
            raise AssertionError(f"impl {impl}: non-finite residuals")
        if not impls[impl]["max_cam_err"] < 0.5:
            raise AssertionError(f"impl {impl}: camera off GT by "
                                 f"{impls[impl]['max_cam_err']}")
        if covariance.LAUNCHES != want:
            raise AssertionError(f"impl {impl}: {covariance.LAUNCHES} downdate "
                                 f"launches, want {want}")
        if impl == 4:
            frame_without_host_sync(run_i, st_i, sc3, [31], noise30[:1])
    emit({"phase": "impls", "K": SC03_K, "frames": len(SC03_IMPL_FRAMES),
          "impls": impls})
    frame_without_host_sync(run3, st3, sc3, [301], ate_noise[:1])
    emit({"phase": "nosync",
          "frames": {"flagship": 242, "control": 241, "scenario03_impl1": 301,
                     "scenario03_impl4": 31}, "host_syncs": 0})
    del params3, sc3, st3_0, st3, run3

    # ---- bundle adjustment: the dino shape, then the 10k x 500 problem ----
    def ba_phase(name, fn):
        ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(device, torch.float32)
        torch.cuda.synchronize()
        out = {"phase": name, "phase_s": time.perf_counter() - t0, **out,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {"ncc_search": ncc_cuda.LAUNCHES,
                            "symmetric_downdate": covariance.LAUNCHES}}
        emit(out)
        if not out["finite"]:
            raise AssertionError(f"{name}: non-finite output")
        if any(out["launches"].values()):
            raise AssertionError(f"{name}: a kernel of another path launched")
        return out

    dino = ba_phase("ba_dino", run_dino)
    ate_bound = 2 * DINO_ATE_F64
    if not dino["err_final"] < dino["err_initial"]:
        raise AssertionError(f"ba_dino: error {dino['err_initial']} -> "
                             f"{dino['err_final']} did not decrease")
    if not dino["map_ate"] <= ate_bound:
        raise AssertionError(f"ba_dino: map ATE {dino['map_ate']} > "
                             f"{ate_bound} (2 x the float64 CPU ATE)")
    scale = ba_phase("ba_at_scale", run_at_scale)
    if not all(scale["solve_ok"].values()):
        raise AssertionError(f"ba_at_scale: solve ok {scale['solve_ok']}")
    if not scale["banded_vs_full"]["agree"]:
        raise AssertionError(f"ba_at_scale: banded and full-width corrections "
                             f"differ: {scale['banded_vs_full']}")
    if not scale["err_after"] < scale["err_before"]:
        raise AssertionError(f"ba_at_scale: LM error {scale['err_before']} -> "
                             f"{scale['err_after']} did not decrease")

    dd_main = dd_times["4621x1536"]
    dd_ms = float(np.mean(dd_main["kernel"]))
    emit({"kernels": [{
        "name": "ncc_surface_argmax", "route": "cuda",
        "source": "surikatoko_tpu_torch/csrc/ncc_search.cu",
        "replaces": "surikatoko_tpu/ops/ncc_pallas.py:92",
        "launches": launches["ncc_search"], "max_abs_err": flag_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": ncc_bound,
        "bound_by": ncc_bound_by, "pct_of_bound": 100.0 * ncc_bound / kernel_ms,
        "library_ms": None}, {
        "name": "symmetric_downdate", "route": "cuda",
        "source": "surikatoko_tpu_torch/csrc/symmetric_downdate.cu",
        "replaces": "surikatoko_tpu/ops/covariance.py:53",
        "launches": launches["symmetric_downdate"], "max_abs_err": dd_err,
        "ms": dd_ms, "plain_ms": float(np.mean(dd_main["plain"])),
        "bound_ms": dd_main["bound_ms"], "bound_by": dd_main["bound_by"],
        "pct_of_bound": 100.0 * dd_main["bound_ms"] / dd_ms,
        "library_ms": float(np.mean(dd_main["addmm"]))}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
