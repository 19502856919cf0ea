#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
the port builds and runs its main paths.

    python3 chip_smoke.py

Phases, one JSON line each:
  env      card, versions, precision flags, the SM clock the bounds assume;
           builds both kernels from the checkout, one nvcc each, started
           together, times the builds and shows ptxas's registers and spills.
  kernel   each kernel against its plain PyTorch version on the card.
           NCC search (csrc/ncc_search.cu): random data at the test shapes,
           at the main path's (K,T,S) = (768,15,15) and at the image loop's
           (48,15,21) and the demo defaults' (32,17,25) (these two also
           timed by events, graph replay and device time beside their
           bound), then the edge
           cases of ncc_edge_case (ragged K = 769, flat windows, exact ties,
           all-false gates, argmaxes on window corners with clamped
           neighbours), each without and with the neighbour output: corr
           (and neighbours) within rtol 1e-4 / atol 1e-5, every differing
           idx a tie within that tolerance, and idx exact where the case
           fixes it; then at (768,15,15) on patches of a rendered flagship
           frame (same tolerance, idx agreement >= 0.99).
           Symmetric downdate (csrc/symmetric_downdate.cu): random symmetric
           P and random M at (D,m) = (43,10) ... (4621,1536) and the ragged
           (129,1), (130,7), (1000,33), without and with a 0/1 keep of ~5%
           zeros: output bitwise symmetric, two launches bitwise equal, and
           |kernel - plain| <= 1e-5 (|P| o |kk^T| + |M o k|^T |M o k|) + 1e-30.
           The downdate's float64 entry point at the same shapes against
           its plain version in float64 on the card: bitwise symmetric, two
           launches bitwise equal, relative Frobenius difference <= 1e-12
           (the DMMA kernel's 64-wide tiles on the FP64 tensor cores).
           All timed with CUDA events over back-to-back calls, over
           replays of a CUDA graph of the calls (which leaves out the host's
           time between launches) and by the profiler's device time, each
           beside its plain version and its bound: the larger of its FMAs
           over the card's f32 rate (132 SMs x 128 lanes x clocks.max.sm)
           and its bytes (inputs read once, outputs written once) over
           3.35 TB/s (float64: FMAs over the FP64 tensor cores' 132 SMs x
           128 FMA a clock x clocks.max.sm, 8-byte values); the downdate,
           in both types, also against a bare masked addmm, its one-call
           yardstick. The search's pct_of_bound is taken from its
           graph-replay time: back-to-back events at its size measure the
           wrapper's host time.
  flagship the churned image-sequence loop at the benchmark configuration
           (K=768 slots, 640x480, 1024-point wide world, recruitment with
           the local depth prior, delete-unobserved), float32: init, 120
           warm-up frames, 120 timed frames. Asserts finite outputs, exact
           P == P^T, one launch of each kernel per frame, recruitment,
           matched median >= K/2 and ATE < 0.30.
  downdate_frame  the downdate kernel against its plain version on the
           (P, B, keep) of one more flagship frame (same tolerance).
  profile  device time by kernel of one more flagship frame
           (torch.profiler), against the timed frames' wall time, and the
           shares of kernels B1 and B2 (B2's counts its row padding copy).
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
  hostloop the host-driven tracker on scenario03's world (K=96, 320x240):
           MonoSlamFilter(update_impl=1) with DemoCornersMatcher (noise 0.5
           from default_rng(3), the whole capacity as frame 0's budget)
           through run_scenario over frames 0-299, in float32 and float64
           on the card, each after a 30-frame warm-up run: fps (host
           clock), ATE, median obs_count, estimated_count at the end, one
           profiled 40-frame run (device busy and idle share per frame).
           One more f32 step runs with torch's sync debug mode raising.
           Asserts finite, P == P^T, one downdate launch per frame, the
           float64 run's first 30 frames within 1e-9 (cam_state) of the
           same run on the CPU with equal counts, and f32 ATE <= 2 x the
           float64 ATE + 0.02.
  imageseq_hostloop  the host-driven image loop of bench.py:371-473: the
           grid world, the camera oscillating over 2 periods of 100 shots,
           200 frames of 320x240 rendered on the host, written as PGM through
           save_picture and read back through FrameLoader(prefetch_depth=4);
           MonoSlamFilter(capacity=48, update_impl=1) from the GT velocity
           with ImageTemplCornersMatcher (templ 15, radius 10, corr 0.6, 48
           corners, 15 px from tracked) through run_image_sequence_pipelined,
           in float32 and float64 on the card: fps of the better of two timed
           runs after a 30-frame warm-up run, ATE, matched median, frame 0's
           recruits, one profiled 40-frame run (device busy, idle share, B1's
           and B2's us a frame), the host syncs a frame that torch's sync
           debug mode reports (runs of 5 and 15 frames), and each stage's
           ms a frame in a 40-frame sequential run synchronized around every
           stage. Asserts native decoding, finite state, P == P^T, one
           B1 and one B2 launch per frame, matched median >= 24, f32 ATE <= 2
           x the f64 ATE + 0.02, and the float64 run's frames 0-29 against
           the same run on the CPU: counts and new slots equal, cam_state
           within 1e-9, up to the first frame where B1's float32 surface (its
           sum order differs from the plain version's) flips a near tie,
           shown with its slot and both corr values, which must lie within
           B1's tolerance. Then KltCornersMatcher (3 levels, window 7, 10
           iterations) over 60 frames in float32: no B1 launch, one B2 launch
           per frame, matched median > 0, fps.
  scenario03_f64  make_scan_runner(1) in float64 on the card, frames 1-30,
           against the CPU: camera positions within 1e-9, P == P^T.
  precision_k768  the K=768 pin of tests/test_precision_large_k.py:
           make_scan_runner(1) on build_oscillating_scenario(768), frames
           1-120, float64 without mitigations and float32 with
           max_undetected_frames=60 and covar_diag_inflation=1e-6; asserts
           finite, matched median > 500 in both, one downdate launch per
           frame, and f32 ATE <= 2 x f64 ATE + 0.02. One more float64 frame
           under the profiler: device busy time, B2's share, top kernels.
  ba_dino  the JAX bench's dino BA (bench.py:587-623), float32
           (demos.bundle_adj_dinosaur.run_dino): the 36 x
           4983 synthetic turntable written in the VGG file formats and read
           back through the loader; the device-loop sparse LM (full-width
           solve, point chunk 1024), 8 iterations warm, 8 timed, then
           converged from the warm result. Asserts finite outputs, a
           decreased error and map ATE <= 2 x the port's float64 CPU ATE.
  ba_at_scale  the 10k-point x 500-frame problem (bench.py:517-585),
           float32 (demos.ba_at_scale.run_at_scale): compute_blocks, the
           full-width and the banded Schur solve (CUDA events), the parts
           of one LM trial, banded = full (in the 2-norm, BAND_RTOL there),
           whether each repeats bit for bit, the Schur FLOP rate against a
           4096^2 matmul chain, the device-loop LM (8 iterations warm, 8
           timed) and one profiled LM iteration. Asserts finite outputs,
           both solves ok and a decreased error.
  mvf_demo the multi-view factorization demo (demos.multi_view_factorization:
           the grid world, the rectangular path, K = 520, 320x240, frames 0-1
           known), 12 frames at noise 0 and 0.5 px, each without and with
           the SE(3) pose-graph closure, in float64 on the card and on the
           CPU and in float32 on the card. Asserts the float64 card run
           within 1e-9 of the CPU's (poses and map), equal point counts,
           ba_runs and each BA's kind, ok, stop reason and iterations; f32 point and camera ATE
           <= 2 x f64 + 0.01; the closure lowers the last camera's position
           error where the run drifted (noise 0: it stays below 1e-4).
  mvf_at_scale  demos.mvf_at_scale.run_at_scale at the JAX demo's defaults:
           10k points, 500 frames + a 12-frame revisit, tracks of 12, 0.5
           px, windowed BA (25 frames) every 5 frames, global sparse BA
           every 25 (10 iterations, point bucket 2048, frame bucket 100),
           the closure's pairs by place recognition (the 12 head frames and
           the revisit rendered, steered BRIEF on the card, mutual-NN
           Hamming matching, a 256-hypothesis similarity RANSAC, threshold
           0.25) and the Sim(3) closure, float32; the final BA of 5
           iterations timed as the best of two warm runs, then 40 more.
           Frame 474's integration, windowed BA and global BA and a second
           run of place recognition run under the profiler. Then the same
           pipeline at bench.py's MVF size (2048 points, 128 frames + 12),
           with the oracle pairs and without. Asserts finite outputs, no
           localization failure, the loop closed in all three runs, map
           ATE <= 0.1, the final BA lowering the error and a measured
           count of correct closure pairs; at bench.py's size the oracle
           closure lowering the trajectory ATE, and place recognition's
           205 x 205 tracks, 100 +- 2 candidates and >= 3 verified pairs,
           >= 90% of them correct. At full size the trajectory ATE is
           reported: there the closure lands at ~0.17-0.23 whatever the
           drift before it, which varies from run to run (PERF.md).
  two_view the two-view toolbox on a synthetic 640x480 pair (2000
           correspondences, 30% outliers, 0.5 px): F by 7-point RANSAC with
           its candidates (512 hypotheses) and an 8-point refit on its
           inliers, E by 5-point RANSAC (512), the relative pose on E's
           inliers, their optimal correction, and Zhang's and the rotating
           camera's calibrations from 10 homographies each; float64 and
           float32 on the card, each step timed by CUDA events, and float64
           on the CPU on the same samples. Asserts the float64 card run
           within 1e-9 of the CPU's (F and E up to sign, K relative, equal
           inlier masks) and finite outputs; reports the f32 rotation error
           and inlier counts.
  batch_eval  batched evaluation. Kernel B2's batched entry points (checked
           and timed right after the kernel phase, where the profiler is
           fresh) at (B,D,m) = (32,589,192), (6,109,32) and (3,130,7) with a
           per-problem keep, float32 and float64: within the kernel phase's
           tolerances of the plain version, bitwise symmetric, repeating,
           each slice bit for bit its own unbatched kernel call, the
           torch.func.vmap route equal to the direct batched call, and a
           shared P and keep (vmap's unbatched arguments) equal to the
           unbatched calls; at (32,589,192) the batched call, its 32
           unbatched calls and a batched masked baddbmm (the one-call
           yardstick) timed by events, graph replay and device time beside
           the bound. Then make_batched_scan_runner(1) on scenario03's world
           with 32 noise seeds (instance 0 scenario03's own), float32, frames
           1-300, against the 32 seeds one after another over frames 1-30:
           instance-frames/s both ways, one profiled frame of each (busy
           share), one B2 launch a frame, per instance finite, P == P^T,
           Cholesky info 0, ATE (median, max), the batched ATE over frames
           1-30 within 0.02 of the unbatched one's and each instance's
           camera positions there within 1e-4 of its unbatched run's (and
           further than that from every other instance's), a batched frame
           free of host syncs, and 4 instances in float64 on the card within
           1e-9 of their unbatched runs on the CPU. Then batch BA
           (demos.batch_ba: the circle grids of default_rng(0..B-1),
           normalize -> LM -> revert as one batch) at B = 32 and 256 in
           float64 and float32, the first 32 also one after another:
           problems/s, converged counts, the batch's outer and trial rounds,
           and in float64 each problem's stop code, iterations and trials in
           both batches equal to its own run; one profiled LM iteration at
           B = 256 (busy share).
  sharded  the distribution layer (surikatoko_tpu_torch/parallel) on a
           one-rank NCCL group, the card's only rank. B2's row-slab entry
           points (checked and timed right after the kernel phase) at (R, D,
           m, r0) = (4608, 4621, 1536, 13), one rank's landmark rows at
           K=768, (1152, 4621, 1536, 1165), rank 1 of four, (13, 4621,
           1536, 0), the camera rows (the thin kernel), and (2304, 4621,
           1536, 13), rank 0 of two, float32 and float64: bit for bit the
           full B2 call's rows, repeating, within the plain version's
           tolerance, timed by events, graph replay and device time beside
           the plain version, a masked addmm of the same rows and the bound
           (R (D - R) m + R (R + 1) / 2 m FMAs: each symmetric pair once);
           each shape's form and grid (covariance.rows_config).
           Then parity.sharded_parity: (a) the sharded fused step at K=768
           in float64 and float32 against the single-device fused step: P ==
           P^T bit for bit, P equal to the single-device P in float64 and
           within 1e-6 of max |P| in float32, the camera-row and own-row
           slabs equal to the full B2 output bit for bit; (b) the sharded
           imageseq runner with bench.py:355-358's settings (the flagship
           world, recruit_max 12, 64 detector corners, the local depth
           prior) over frames 1-8 against make_imageseq_scan_runner:
           sharded_pallas_matched_absdiff <= 5 (bench.py's name and limit)
           and sharded_pos_maxdiff, one B1 and two B2-slab launches a frame
           and no full B2 launch, then frames 9-40 timed (fps) and one
           profiled frame (busy share); (c) the banded point-sharded BA at
           2048 x 100: its first trial's du and dX within BAND_RTOL of the
           full-width single-device solve (relative 2-norm), the LM lowering
           the error with the plan engaged. (d) dryrun_multichip(1) in a
           rank of its own; (f) the MonoSlam demo's main path
           (demos/davison_mono_slam) on configs/scenario01.json, its whole
           40-frame path, no views, float64 (its default; ATE within 1e-6
           of the CPU's) and float32 (ATE <= 2 x the float64 ATE + 0.02):
           fps and ATE.
  Neither the BA, the MVF, the two-view phases nor batch BA may launch
  kernel B1 or B2.
Then a line with every kernel's launches, error and times (B2's row-slab
entry points as a kernel of their own, their launches those of the sharded
imageseq run, with every slab shape's form, times, bound, plain and addmm
times and whether it beat the addmm; B2's batched
entry points' at (32,589,192) in both types too, and its float64 entry
point's: its tile edge, its launches in precision_k768's float64
run, and whether it beat its one-call yardstick; each kernel's launches on
each path that launches it; B1's times at the image loop's shapes), the
card's name
and power limit as nvidia-smi gives them, and the last line
{"ok": true, "device": {...}}. Any failure raises and exits nonzero; with
no CUDA device it exits 1 before printing anything on stdout.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from surikatoko_tpu_torch.demos.ba_at_scale import run_at_scale
from surikatoko_tpu_torch.demos.bundle_adj_dinosaur import run_dino
from surikatoko_tpu_torch.utils.profiling import cuda_ms, device_profile

K_FLAGSHIP = 768
# (K, T, S): the CPU tests' shapes and the main path's, then the image
# loop's (IMSEQ_SHAPES: bench.py's matcher, the demo's default T = 17, R = 12)
IMSEQ_SHAPES = ((48, 15, 21), (32, 17, 25))
TEST_SHAPES = ((8, 9, 7), (5, 17, 25), (3, 9, 11), (768, 15, 15)) + IMSEQ_SHAPES
RTOL, ATOL = 1e-4, 1e-5
# the search kernel's edge cases (ncc_edge_case); all but "ragged" have an
# argmax known exactly by construction
NCC_EDGE_CASES = ("ragged", "flat", "ties", "ties_small", "gated_rows",
                  "corners")
WARM_FRAMES = range(1, 121)
TIMED_FRAMES = range(121, 241)
# (D, m) of the downdate: tests, scenario03 (K=96), the flagship (K=768) and
# ragged edges (D past a tile edge, m not a multiple of 16)
DOWNDATE_SHAPES = ((43, 10), (256, 32), (300, 64), (589, 192), (4621, 1536),
                   (129, 1), (130, 7), (1000, 33))
DOWNDATE_TIMED = ((589, 192), (4621, 1536))
# the float64 kernel against its plain version: relative Frobenius bound
F64_REL_FRO = 1e-12
# the device kernels of one downdate call: the row padding copy (128-wide
# tiles only) and the downdate itself
DOWNDATE_DEVICE_KERNELS = ("pad_rows", "downdate_kernel")
NCC_DEVICE_KERNELS = ("ncc_search_kernel",)
# the sharded phase: B2's row slabs (R, D, m, r0) of one rank at K=768, of
# rank 1 of four, of the camera rows (the main path's two slabs a frame are
# the first and the third) and of rank 0 of two; the imageseq frames
# compared (bench.py:351) and timed; the banded point-sharded BA (points,
# frames, track length)
SLAB_SHAPES = ((4608, 4621, 1536, 13), (1152, 4621, 1536, 13 + 1152),
               (13, 4621, 1536, 0), (2304, 4621, 1536, 13))
SHARDED_FRAMES = range(1, 9)
SHARDED_TIMED = range(9, 41)
SHARDED_BA = (2048, 100, 12)
# the MonoSlam demo's main path (demos/davison_mono_slam.run) on
# configs/scenario01.json, whose rectangular path is 40 frames long (frames
# asked for past it are not run), and its float64 trajectory ATE on the CPU:
#   python3 -c "import chip_smoke as c; print(c.demo_ate('cpu'))"
DEMO_CONFIG, DEMO_FRAMES = "configs/scenario01.json", 40
DEMO_ATE_F64 = 0.05146112052501679
# profiles taken for one device time before it counts as not measured
PROFILE_TRIES = 3

# the published peak rate of HBM3 on an H100 SXM (bytes/s); f32 lanes per
# SM; FP64 FMAs per SM and clock on the FP64 tensor cores (DMMA), twice the
# 64 FP64 vector lanes: NVIDIA's 67 TFLOP/s FP64 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
F32_LANES_PER_SM = 128
F64_FMA_PER_SM_CLOCK = 128

SC03_K = 96
SC03_SEED = 3
SC03_ATE_FRAMES = range(1, 301)
SC03_CHUNK = 300
SC03_IMPL_FRAMES = range(1, 31)
# The port's float64 ATE of scenario03 over frames 1-300 with the noise of
# SC03_SEED, on the CPU:
#   python3 -c "import chip_smoke as c; print(c.scenario03_ate('cpu'))"
SC03_ATE_F64 = 0.00711121305080296
# float64 on the card against float64 on the CPU: camera within this
F64_CAM_TOL = 1e-9
SC03_F64_FRAMES = range(1, 31)

# the host-driven tracker on the scenario03 world (K=96): frames 0-299 timed
# after a warm-up run of 30, one profiled run of 40, and the first 30 frames
# of the float64 run against the CPU
HOSTLOOP_FRAMES, HOSTLOOP_WARM, HOSTLOOP_PROFILE, HOSTLOOP_CPU = 300, 30, 40, 30

# the host-driven image loop (bench.py:371-473): 200 frames timed after a
# warm-up run of 30, a profiled run of 40, the first 30 frames of the
# float64 run against the CPU, and the KLT matcher over 60 frames
IMSEQ_K, IMSEQ_FRAMES, IMSEQ_WARM, IMSEQ_PROFILE, IMSEQ_CPU, IMSEQ_KLT = (
    48, 200, 30, 40, 30, 60)
# frames of the two runs whose host syncs are counted (their difference is
# IMSEQ_SYNC_FRAMES[1] - IMSEQ_SYNC_FRAMES[0] frames' worth)
IMSEQ_SYNC_FRAMES = (5, 15)
IMSEQ_MATCHER = dict(templ_width=15, search_radius=10, min_corr_coeff=0.6,
                     detector_max_corners=48, min_distance_new_to_tracked=15.0)
IMSEQ_KLT_KW = dict(klt_levels=3, klt_win=7, klt_iters=10)

# the K=768 f32-vs-f64 pin (tests/test_precision_large_k.py, ekf mode):
# make_scan_runner(1) over frames 1-120 of build_oscillating_scenario(768),
# detection noise from default_rng(PK_SEED)
PK_K, PK_FRAMES, PK_SEED = 768, range(1, 121), 7
PK_MITIGATIONS = dict(max_undetected_frames=60, covar_diag_inflation=1e-6)

# The port's float64 map ATE of the dino phase (its runner, run_dino, and
# the at-scale BA's, run_at_scale, live in demos/bundle_adj_dinosaur.py and
# demos/ba_at_scale.py), on the CPU:
#   python3 -c "from surikatoko_tpu_torch.demos.bundle_adj_dinosaur import dino_ate; print(dino_ate('cpu'))"
DINO_ATE_F64 = 0.00255877485559129

# the multi-view factorization demo's world (demo_multi_view_factorization:
# the grid, the rectangular path, K = 520, 320x240, frames 0-1 known), 12
# frames, each (noise_pix, loop_closure) case in float64 on the card and
# on the CPU and in float32 on the card
MVF_DEMO_FRAMES = 12
MVF_DEMO_CASES = ((0.0, False), (0.0, True), (0.5, False), (0.5, True))
# the last camera's position error, float32 or float64, on a run without
# drift (noise 0): below this the closure has nothing to lower
MVF_NO_DRIFT = 1e-4
# the at-scale MVF pipeline at the JAX demo's defaults (demo_mvf_at_scale:
# 10k points, 500 frames + a 12-frame revisit, tracks of 12, 0.5 px,
# windowed BA of 25 frames every 5, global BA every 25, oracle pairs), in
# float32; the frame whose integration, windowed and global BA run under
# the profiler (both BA run after it); its map ATE bound
# (test_mvf_sparse.py:154)
MVF_SCALE = dict(points=10_000, frames=500, revisit_frames=12)
MVF_PROFILE_FRAME = 474
MVF_MAP_ATE_BOUND = 0.1
# bench.py's MVF size (bench.py:629-636: 2048 points, 128 frames + 12), at
# which the closure's effect on the trajectory ATE exceeds the run-to-run
# spread of the drift (PERF.md): with the oracle pairs the closure is held
# to lowering the trajectory ATE there (at MVF_SCALE it is reported);
# without them, place recognition to its tracks and candidates (the JAX
# package's 205 x 205 tracks and 100 candidates on the CPU and the TPU) and
# to enough verified pairs, nearly all correct
MVF_CLOSURE_CHECK = dict(points=2048, frames=128, revisit_frames=12)
PR_BENCH_TRACKS = (205, 205)
PR_BENCH_CANDIDATES, PR_BENCH_CANDIDATES_SLACK = 100, 2
PR_MIN_VERIFIED, PR_MIN_CORRECT_SHARE = 3, 0.9

# the two-view phase: a synthetic 640x480 pair (K = 500 px, the camera
# moved as in test_mvg.py), 2000 correspondences with 0.5 px noise, 30% of
# them outliers; 512 RANSAC hypotheses each for F (7-point, its candidates,
# 8-point refit on the inliers) and E (5-point), inliers within 2 px
# (Sampson); 10 homographies for each calibration; float64 on the card
# against the CPU on the same samples within TWO_VIEW_F64_TOL (K relative
# to its largest entry, F and E up to sign)
TWO_VIEW = dict(n=2000, outlier_share=0.3, noise_px=0.5, hypotheses=512,
                thresh_px=2.0, homographies=10, seed=0)
TWO_VIEW_F64_TOL = 1e-9
TWO_VIEW_REPS = 5

# batched evaluation. Kernel B2 with a batch axis at (B, D, m): 32 scan
# runner instances at scenario03's K = 96, a test shape, and a ragged one;
# each with a per-problem keep, in float32 and float64; the first is timed
BATCH_DOWNDATE_SHAPES = ((32, 589, 192), (6, 109, 32), (3, 130, 7))
# the scan runner over noise seeds: B instances of scenario03 (impl 1,
# float32; instance 0 takes scenario03's own noise, the others draws of
# default_rng(BATCH_SEED)) over frames 1-300, against the B instances one
# after another over frames 1-30; float64 at BATCH_F64 instances on the
# card against the CPU over frames 1-30 (F64_CAM_TOL); per instance the
# float32 batched ATE over frames 1-30 within BATCH_F32_ATE_TOL of its
# unbatched run's, and its camera positions within BATCH_F32_CAM_TOL of
# them (1.35e-5 read on an H100: the rounding of the batched products);
# two instances' positions lie further apart than that, so a batch that
# handed an instance another's noise fails
BATCH_SCAN_B, BATCH_SEED, BATCH_F64 = 32, 11, 4
BATCH_SCAN_FRAMES, BATCH_SEQ_FRAMES = range(1, 301), range(1, 31)
BATCH_F32_ATE_TOL = 0.02
BATCH_F32_CAM_TOL = 1e-4
# batch BA: the batch demo's circle grids (demos.batch_ba at its defaults),
# B = 32 and 256 in float64 and float32, the first 32 also one after another
BATCH_BA_SIZES, BATCH_BA_SEQ = (32, 256), 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, units: bool = True) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    fmt = "--format=csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", fmt],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


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


def profiled(fn, host_ops: bool = True):
    """device_profile of one call of ``fn``. A profile that recorded no
    device event at all is taken again, PROFILE_TRIES times in all; then it
    raises, so no time is reported that was not measured."""
    for _ in range(PROFILE_TRIES):
        prof = device_profile(fn, host_ops)
        if prof[0] > 0:
            return prof
    raise RuntimeError(f"{PROFILE_TRIES} profiles recorded no device event")


def device_us_per_call(fn, calls: int = 5) -> float:
    """Mean device time of one call of ``fn`` over ``calls`` calls under the
    profiler (one profiled call alone varies by tens of percent)."""
    return profiled(lambda: [fn() for _ in range(calls)])[0] / calls


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


def ncc_edge_case(name: str, rng):
    """numpy (patches, templates, gate) of one of NCC_EDGE_CASES, each with
    its argmax known by construction:
      ragged      random data at K = 769 (a ragged last block of landmarks);
      flat        zero patches or constant templates: every denominator is
                  0, so raw = 0 and idx = the first gated cell;
      ties, ties_small  integer patches of period p = T/3 (5 at T = 15, 3 at
                  T = 9) and templates equal to one of their windows, with
                  an integer mean: every congruent placement scores the
                  same bits, so idx = the lowest gated one;
      gated_rows  random data with every third landmark's gate all false
                  (-inf at index 0);
      corners     templates cut from a window corner of their patch, so the
                  argmax sits on it and the neighbours are clamped."""
    K, T, S = {"ragged": (769, 15, 15), "ties_small": (16, 9, 11),
               "gated_rows": (64, 15, 15)}.get(name, (16, 15, 15))
    P = S + T - 1
    patches = rng.uniform(0, 255, size=(K, P, P)).astype(np.float32)
    templs = rng.uniform(0, 255, size=(K, T, T)).astype(np.float32)
    gate = rng.uniform(size=(K, S, S)) < 0.7
    gate[:, S // 2, S // 2] = True
    if name == "flat":
        patches[: K // 2] = 0.0
        templs[K // 2:] = rng.integers(0, 256, size=(K - K // 2, 1, 1))
        gate = rng.uniform(size=(K, S, S)) < 0.3
    elif name in ("ties", "ties_small"):
        p = T // 3
        for k in range(K):
            base = rng.integers(0, 32, size=(p, p))
            base[0, 0] += (-base.sum()) % (p * p)  # integer template mean
            a, b = rng.integers(0, p, size=2)
            patches[k] = np.tile(base, (P // p + 1, P // p + 1))[:P, :P]
            templs[k] = patches[k, a:a + T, b:b + T]
            gate[k, a + p, b + p] = True
    elif name == "gated_rows":
        gate[::3] = False
    elif name == "corners":
        for k in range(K):
            oy, ox = ((0, 0), (0, S - 1), (S - 1, 0), (S - 1, S - 1))[k % 4]
            templs[k] = patches[k, oy:oy + T, ox:ox + T]
            gate[k, oy, ox] = True
    return patches, templs, gate


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


def downdate_case(D, m, with_keep, device, dtype=None):
    """Random symmetric PSD P [D,D], M [m,D] and a 0/1 keep of ~5% zeros,
    in float32 unless ``dtype`` says otherwise."""
    import torch
    dtype = dtype or torch.float32
    g = torch.Generator(device=device).manual_seed(D * 7 + m)
    A = torch.randn(D, D, generator=g, device=device, dtype=dtype)
    P = A @ A.T / D
    P = torch.tril(P) + torch.tril(P, -1).T
    M = 0.05 * torch.randn(m, D, generator=g, device=device, dtype=dtype)
    keep = ((torch.rand(D, generator=g, device=device, dtype=dtype) > 0.05)
            .to(dtype) if with_keep else None)
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


def compare_downdate_f64(cov, P, M, keep):
    """The float64 kernel vs its plain version in float64 on the card:
    (relative Frobenius difference, ok) with ok = bitwise symmetric, a
    second launch bitwise equal to the first, finite, and the relative
    difference <= F64_REL_FRO (both sum m products in double, in other
    orders: ~sqrt(m) 1.1e-16 of the summands' scale)."""
    import torch
    got = cov.symmetric_downdate(P, M, keep)
    again = cov.symmetric_downdate(P, M, keep)
    want = cov.symmetric_downdate_ref(P, M, keep)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    ok = (got.dtype == torch.float64 and torch.equal(got, got.T)
          and torch.equal(got, again) and bool(torch.isfinite(got).all())
          and rel <= F64_REL_FRO)
    return rel, ok


def flagship_setup(device):
    from surikatoko_tpu_torch.parallel.parity import flagship_world
    return flagship_world(K_FLAGSHIP, device)


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


def host_syncs(fn) -> int:
    """Synchronizing CUDA calls that torch's sync debug mode reports while
    ``fn()`` runs (a prototype detector: it may miss some)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing" in str(w.message) for w in caught)


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


def kernel_share(kernels, names) -> list:
    """[device us, device launches] of one hand-written kernel in a profile:
    the device kernels whose names contain one of ``names`` (for B2 its
    downdate kernel and, at 128-wide tiles, the row padding copy launched
    before it in the same wrapper call)."""
    rows = [v for k, v in kernels.items() if any(n in k for n in names)]
    return [sum(v[0] for v in rows), sum(v[1] for v in rows)]


def oscillating_world(device, dtype, K, **param_kw):
    """The JAX bench's scenario03 camera and filter parameters
    (bench.py:113-127) and ``build_oscillating_scenario(K)``."""
    from surikatoko_tpu_torch.geom import camera
    from surikatoko_tpu_torch.models.monoslam import make_params
    from surikatoko_tpu_torch.world.device_runner import build_oscillating_scenario
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype, device=device)
    params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype,
                         device=device, **param_kw)
    return params, build_oscillating_scenario(capacity=K, dtype=dtype,
                                              device=device)


def scenario03_setup(device, dtype):
    """The JAX bench's scenario03 (bench.py:113-127) at K=96, bootstrapped
    from GT, and its standard-normal detection noise from SC03_SEED: [96,2]
    for the bootstrap, [300,96,2] for the ATE frames, [3,300,96,2] for the
    timed windows. Returns (params, sc, state, ate_noise, timed_noise)."""
    import torch
    from surikatoko_tpu_torch.models.monoslam import init_state
    from surikatoko_tpu_torch.world.device_runner import init_with_gt_landmarks
    params, sc = oscillating_world(device, dtype, SC03_K)
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


def hostloop_runner(device, dtype):
    """The host-driven tracker on the scenario03 world: (run, tracker),
    where run(n) builds a fresh ``DemoCornersMatcher`` (detection noise 0.5
    from default_rng(SC03_SEED), the whole capacity as the first frame's
    budget) and returns ``run_scenario`` over frames 0 .. n-1 with
    ``tracker = MonoSlamFilter(update_impl=1, capacity=96)``."""
    from surikatoko_tpu_torch.geom.se3 import SE3
    from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
    from surikatoko_tpu_torch.world.demo_matcher import DemoCornersMatcher
    from surikatoko_tpu_torch.world.runner import run_scenario
    params, sc = oscillating_world(device, dtype, SC03_K)
    tracker = MonoSlamFilter(params, capacity=SC03_K, update_impl=1)
    gt = SE3(sc.gt_cfw_R, sc.gt_cfw_t)

    def run(n_frames):
        matcher = DemoCornersMatcher(
            tracker, gt, sc.gt_points, detection_noise_std=0.5,
            seed=SC03_SEED, max_new_in_first_frame=SC03_K)
        return run_scenario(tracker, matcher, gt, n_frames=n_frames)
    return run, tracker


def hostloop_summary(res) -> dict:
    """ATE (Umeyama-aligned, against the GT camera centres), counts and the
    end state's health of one ``run_scenario`` result."""
    import torch
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    st = res.state
    obs = [int(s.obs_count) for s in res.stats]
    return {"frames": len(res.stats),
            "ate": float(aligned_rmse(torch.as_tensor(res.cam_pos_est),
                                      torch.as_tensor(res.cam_pos_gt))),
            "max_cam_err": float(res.cam_pos_err.max()),
            "obs_count_med": float(np.median(obs)),
            "estimated_count_end": int(res.stats[-1].estimated_count),
            "deleted_total": sum(int(s.deleted_count) for s in res.stats),
            "finite": bool(torch.isfinite(st.x).all()
                           and torch.isfinite(st.P).all()
                           and np.isfinite(res.cam_pos_est).all()),
            "P_exactly_symmetric": bool(torch.equal(st.P, st.P.T))}


@functools.lru_cache(maxsize=1)
def imageseq_world():
    """bench.py:385-404: the grid world in WorldBounds(0, 0.6, 0, 0.6, 0,
    0.6001) and the camera oscillating right and left (2 periods of 100
    shots), in float64 on the host: (points in the tracker frame [N,3]
    numpy, GT camera-from-tracker SE3 [200])."""
    import torch
    from surikatoko_tpu_torch.geom.se3 import SE3
    from surikatoko_tpu_torch.world import scene_gen
    from surikatoko_tpu_torch.world.runner import gt_poses_in_tracker_frame
    wb = scene_gen.WorldBounds(0.0, 0.6, 0.0, 0.6, 0.0, 0.6001)
    pts_world = scene_gen.generate_grid_points(wb, (0.5, 0.5, 0.5), 0.2)
    center = np.array([0.3, 0.3, 0.3])
    gt_world = scene_gen.oscillate_right_and_left(
        center + np.array([0, -1.5, 0]), center, (0, 0, 1), max_deviation=0.3,
        periods_count=2, shots_per_period=100, const_view_dir=True)
    tfw = SE3(gt_world.R[0], gt_world.t[0])
    pts = (pts_world @ tfw.R.T + tfw.t).numpy()
    gt = gt_poses_in_tracker_frame(gt_world)
    return pts, SE3(gt.R.to(torch.float64), gt.t.to(torch.float64))


def imageseq_params(device, dtype):
    """bench.py:404-411's camera (320x240) and filter parameters."""
    from surikatoko_tpu_torch.geom import camera
    from surikatoko_tpu_torch.models.monoslam import make_params
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01),
                                 dtype=dtype, device=device)
    return make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.02,
                       process_noise_ang_veloc_std=0.005,
                       measurm_noise_std_pix=1.0, sal_pnt_init_inv_dist=0.6,
                       sal_pnt_init_inv_dist_std=0.6, dtype=dtype, device=device)


def render_host(f: int) -> np.ndarray:
    """Frame ``f`` of the image loop as bench.py:413-430 renders it (and
    tests/test_imageseq.py's render_world): every visible GT point splatted
    as a Gaussian blob on a static noise background, uint8 [H,W]."""
    import torch
    from surikatoko_tpu_torch.geom import camera
    pts, gt = imageseq_world()
    H, W, sigma = 240, 320, 1.8
    xc = pts @ gt.R[f].numpy().T + gt.t[f].numpy()
    vis = xc[:, 2] > 1e-6
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01),
                                 dtype=torch.float64, device="cpu")
    pix = camera.project_camera_point(cam, None, torch.as_tensor(xc)).numpy()
    img = np.random.default_rng(0).uniform(20, 60, size=(H, W))
    ys, xs = np.mgrid[0:H, 0:W]
    for k in np.nonzero(vis)[0]:
        x, y = pix[k]
        if -10 < x < W + 10 and -10 < y < H + 10:
            img += 170.0 * np.exp(-((xs - x) ** 2 + (ys - y) ** 2)
                                  / (2 * sigma ** 2))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_imageseq(directory: str, n_frames: int = IMSEQ_FRAMES) -> None:
    """Render frames 0 .. n_frames-1 and write them as PGM
    (``%06d.pgm``) through the port's save_picture."""
    from surikatoko_tpu_torch.vision.picture import save_picture
    imageseq_world()

    def one(f):
        save_picture(os.path.join(directory, f"{f:06d}.pgm"), render_host(f))
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(one, range(n_frames)))


def imageseq_run(directory, device, dtype, n_frames=None, klt=False,
                 record=False, pipelined=True, instrument=None):
    """One run of the host-driven image loop: a fresh
    MonoSlamFilter(capacity=48, update_impl=1) started from the GT velocity,
    the NCC (or KLT) matcher, frames 0 .. n_frames-1 of ``directory``
    through FrameLoader(prefetch_depth=4) and run_image_sequence_pipelined
    (or the sequential loop). With ``record`` the matcher keeps every NCC
    search result (on the device); ``instrument(tracker, matcher)`` may wrap
    their methods before the run. Returns (state, stats, matcher,
    loader.native, seconds by the host clock, synchronized at the end)."""
    import torch
    from surikatoko_tpu_torch.io.frame_loader import FrameLoader
    from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
    from surikatoko_tpu_torch.vision import matcher as mt
    from surikatoko_tpu_torch.world import runner
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    tracker = MonoSlamFilter(imageseq_params(device, dtype), capacity=IMSEQ_K,
                             update_impl=1)
    if klt:
        matcher = mt.KltCornersMatcher(tracker, **IMSEQ_MATCHER, **IMSEQ_KLT_KW)
    else:
        matcher = mt.ImageTemplCornersMatcher(tracker, **IMSEQ_MATCHER)
    if record:
        matcher.records, search = [], matcher._search

        def recorded(*args, **kw):
            res = search(*args, **kw)
            matcher.records.append(res)
            return res
        matcher._search = recorded
    if instrument is not None:
        instrument(tracker, matcher)
    st0 = runner.init_tracker_state_from_gt(tracker, imageseq_world()[1])
    run = (runner.run_image_sequence_pipelined if pipelined
           else runner.run_image_sequence)
    sync()
    t0 = time.perf_counter()
    with FrameLoader(directory, prefetch_depth=4, device=device) as fl:
        frames = itertools.islice((g for _, g in fl), n_frames)
        st, stats = run(tracker, matcher, frames, st0)
        native = fl.native
    sync()
    return st, stats, matcher, native, time.perf_counter() - t0


def imageseq_stages(directory, device, dtype, n_frames) -> dict:
    """Host-clock ms a frame of each stage of the sequential image loop,
    with the card synchronized before and after every stage (so each
    stage's own host and device time, without the pipelined overlap):
    analyze (upload), match (prediction, gate, B1, the read), recruit
    (detection, suppression, the read), the filter step, and the template
    bookkeeping (its reads)."""
    import torch
    from surikatoko_tpu_torch.vision import matcher as mt
    from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    ms = {}

    def timed(name, fn):
        def run(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            ms[name] = ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out
        return run

    def make(tracker, matcher):
        for name, obj, attr in (
                ("analyze", matcher, "analyze_frame"),
                ("match", matcher, "match_salient_points"),
                ("recruit", matcher, "recruit_new_salient_points"),
                ("filter_step", tracker, "process_frame"),
                ("bookkeeping", matcher, "on_landmarks_added"),
                ("bookkeeping", matcher, "sync_removed")):
            setattr(obj, attr, timed(name, getattr(obj, attr)))
    imageseq_run(directory, device, dtype, n_frames, pipelined=False,
                 instrument=make)
    return {k: v / n_frames for k, v in ms.items()}


def imageseq_summary(st, stats) -> dict:
    """ATE (Umeyama-aligned, against the GT camera centres), counts and the
    end state's health of one image-loop run; one read of the stats."""
    import torch
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    gt = imageseq_world()[1]
    n = len(stats)
    pos = torch.stack([s.cam_state[:3] for s in stats]).double().cpu()
    counts = torch.stack([torch.stack([s.obs_count, s.new_count,
                                       s.estimated_count]) for s in stats]
                         ).cpu().numpy()
    gt_pos = -torch.einsum("fji,fj->fi", gt.R[:n], gt.t[:n])
    return {"frames": n, "ate": float(aligned_rmse(pos, gt_pos)),
            "obs_count_med": float(np.median(counts[:, 0])),
            "recruits_frame0": int(counts[0, 1]),
            "recruited_total": int(counts[:, 1].sum()),
            "estimated_count_end": int(counts[-1, 2]),
            "finite": bool(torch.isfinite(st.x).all() and torch.isfinite(st.P).all()
                           and torch.isfinite(pos).all()),
            "P_exactly_symmetric": bool(torch.equal(st.P, st.P.T))}


def imageseq_card_vs_cpu(card, cpu, n_frames: int) -> dict:
    """The float64 image loop on the card against the same run on the CPU,
    frame by frame (each a (stats, matcher with records) pair): the B1
    results, then obs and new counts, new slots and cam_state within
    F64_CAM_TOL. At the first frame where the match differs (B1's float32
    surface sums in another order than its plain version, so a near tie may
    flip), each differing slot is shown with both corr values, which must
    agree within RTOL / ATOL; the comparison holds the frames before it."""
    import torch
    (st_a, m_a), (st_b, m_b) = card, cpu
    held, flips, cam_diff = n_frames, [], 0.0
    for f in range(n_frames):
        ra, rb = m_a.records[f], m_b.records[f]
        ma, mb = ra.matched.cpu(), rb.matched
        ca, cb = ra.best_center.cpu(), rb.best_center
        differ = (ma != mb) | (ma & (ca != cb).any(dim=1))
        if bool(differ.any()):
            corr_a, corr_b = ra.best_corr.cpu().double(), rb.best_corr.double()
            for k in torch.nonzero(differ)[:, 0].tolist():
                a, b = float(corr_a[k]), float(corr_b[k])
                flips.append({"frame": f, "slot": k, "corr_card": a,
                              "corr_cpu": b, "center_card": ca[k].tolist(),
                              "center_cpu": cb[k].tolist()})
                if not abs(a - b) <= ATOL + RTOL * abs(b):
                    raise AssertionError(f"image loop: B1 on the card and its "
                                         f"plain version part by more than a "
                                         f"near tie: {flips[-1]}")
            held = f
            break
        sa, sb = st_a[f], st_b[f]
        for name in ("obs_count", "new_count"):
            if int(getattr(sa, name)) != int(getattr(sb, name)):
                raise AssertionError(f"image loop frame {f}: {name} "
                                     f"{int(getattr(sa, name))} on the card, "
                                     f"{int(getattr(sb, name))} on the CPU")
        if not torch.equal(sa.new_slots.cpu(), sb.new_slots):
            raise AssertionError(f"image loop frame {f}: new slots differ")
        cam_diff = max(cam_diff, float((sa.cam_state.cpu() - sb.cam_state)
                                       .abs().max()))
        if not cam_diff <= F64_CAM_TOL:
            raise AssertionError(f"image loop frame {f}: cam_state differs "
                                 f"by {cam_diff} from the CPU")
    return {"frames": n_frames, "frames_held": held,
            "cam_state_max_abs_diff": cam_diff, "tol": F64_CAM_TOL,
            "near_tie_flips": flips}


def precision_run(device, dtype, mitigations: bool, profile: bool = False) -> dict:
    """One run of the K=768 pin: GT bootstrap, make_scan_runner(1) over
    PK_FRAMES; (ATE, matched median, finite, Cholesky infos, wall s, kernel
    launches during the run) and with ``profile`` one more frame under the
    profiler (device busy us, B2's [us, launches], top kernels)."""
    import torch
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    from surikatoko_tpu_torch.models.monoslam import init_state
    from surikatoko_tpu_torch.ops import covariance, ncc_cuda
    from surikatoko_tpu_torch.world.device_runner import (
        init_with_gt_landmarks, make_scan_runner)
    params, sc = oscillating_world(device, dtype, PK_K,
                                   **(PK_MITIGATIONS if mitigations else {}))
    rng = np.random.default_rng(PK_SEED)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    noise0 = t(rng.standard_normal((PK_K, 2)))
    noise = t(rng.standard_normal((len(PK_FRAMES), PK_K, 2)))
    st = init_with_gt_landmarks(params, sc, init_state(PK_K, dtype=dtype,
                                                       device=device), noise0)
    run = make_scan_runner(params, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st2, errs, n, pos, info = run(st, sc, PK_FRAMES, noise)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"ncc_search": ncc_cuda.LAUNCHES,
                "symmetric_downdate": covariance.LAUNCHES}
    finite = bool(torch.isfinite(st2.x).all() and torch.isfinite(pos).all())
    out = {"dtype": str(dtype).replace("torch.", ""),
           "mitigations": mitigations, "frames": len(PK_FRAMES), "s": dt,
           "ate": float(aligned_rmse(pos.double(),
                                     gt_positions(sc, PK_FRAMES).double())),
           "matched_med": float(np.median(n.cpu().numpy())),
           "finite": finite, "chol_info_nonzero": int(torch.count_nonzero(info)),
           "P_exactly_symmetric": bool(torch.equal(st2.P, st2.P.T)),
           "launches": launches}
    if profile:
        frame = PK_FRAMES[-1] + 1
        busy, nlaunch, top, by_kernel = device_profile(
            lambda: run(st2, sc, [frame], noise[:1]))
        out["profile_frame"] = {
            "frame": frame, "device_busy_us": busy, "device_launches": nlaunch,
            "symmetric_downdate_us_launches": kernel_share(
                by_kernel, DOWNDATE_DEVICE_KERNELS),
            "top_kernels_us_count": top}
    return out


def mvf_state(m) -> dict:
    """A factorizer's poses and map as float64 host arrays."""
    return {"R": np.stack(m.cam_cfw_R).astype(np.float64),
            "t": np.stack(m.cam_cfw_t).astype(np.float64),
            "points": {int(k): np.asarray(v, np.float64)
                       for k, v in m.point_coords.items()}}


def mvf_state_diff(a: dict, b: dict) -> float:
    """Max |difference| of two factorizer states (inf if their maps hold
    other tracks)."""
    if sorted(a["points"]) != sorted(b["points"]):
        return float("inf")
    return float(max(np.abs(a["R"] - b["R"]).max(),
                     np.abs(a["t"] - b["t"]).max(),
                     max((np.abs(a["points"][k] - b["points"][k]).max()
                          for k in a["points"]), default=0.0)))


def mvf_demo_case(device, noise: float, closure: bool) -> dict:
    """One case of the MVF demo: float64 on the card against float64 on the
    CPU (state difference, counts, each BA's kind, ok, stop reason and
    iterations) and float32 on the card; its metrics and checks."""
    import torch
    from surikatoko_tpu_torch.demos import multi_view_factorization as demo
    runs = {}
    for name, dev, dtype in (("card_f64", device, torch.float64),
                             ("cpu_f64", "cpu", torch.float64),
                             ("card_f32", device, torch.float32)):
        m, res = demo.run_factorizer(MVF_DEMO_FRAMES, noise, closure, seed=0,
                                     device=dev, dtype=dtype)
        runs[name] = (mvf_state(m), res)
    (s64, r64), (scpu, rcpu), (_, r32) = (runs["card_f64"], runs["cpu_f64"],
                                          runs["card_f32"])
    bas = lambda r: [b[:4] for b in r["ba_log"]]
    diff = mvf_state_diff(s64, scpu)
    checks = {
        "f64_card_vs_cpu_within_tol": diff <= F64_CAM_TOL,
        "f64_counts_equal": (r64["points"] == rcpu["points"]
                             and r64["ba_runs"] == rcpu["ba_runs"]
                             and r64["integrated"] == rcpu["integrated"]),
        "f64_ba_iters_and_stops_equal": bas(r64) == bas(rcpu),
        "finite": all(np.isfinite(r[k]) for r in (r64, r32, rcpu)
                      for k in ("point_ate", "camera_ate")),
        "f32_point_ate_within": r32["point_ate"] <= 2 * r64["point_ate"] + 0.01,
        "f32_camera_ate_within": r32["camera_ate"]
        <= 2 * r64["camera_ate"] + 0.01}
    if closure:
        # where the run drifted, the closure lowers the last camera's
        # error; without noise there is no drift, and the error stays at
        # the type's rounding
        checks["closure_lowers_end_err"] = all(
            r["end_err_after_closure"] < r["end_err_before_closure"]
            or max(r["end_err_after_closure"],
                   r["end_err_before_closure"]) < MVF_NO_DRIFT
            for r in (r64, r32, rcpu))
    keep = ("points", "point_ate", "camera_ate", "ba_runs",
            "end_err_before_closure", "end_err_after_closure", "seconds")
    return {"noise_pix": noise, "loop_closure": closure,
            "f64_card_vs_cpu_max_abs": diff, "tol": F64_CAM_TOL,
            **{name: {k: r[k] for k in keep} for name, (_, r) in runs.items()},
            "ba_log_f64_card": r64["ba_log"], "ba_log_f32_card": r32["ba_log"],
            "checks": checks}


def run_mvf_at_scale(device, dtype, **overrides) -> dict:
    """demos.mvf_at_scale.run_at_scale at the JAX demo's defaults
    (MVF_SCALE, pairs by place recognition), with frame MVF_PROFILE_FRAME's
    integration, windowed BA and global BA and a second run of the
    closure's place recognition each under the profiler (device only) and
    torch's sync debug mode: device busy us, launches, the host syncs it
    reports, and the idle share against the median wall of that stage's
    uninstrumented runs within 25 frames of it (place recognition: its
    uninstrumented run; the instruments slow the profiled run itself
    several-fold)."""
    import torch
    from surikatoko_tpu_torch.demos import mvf_at_scale as mas
    profiles = {}

    def profiler(name, fn):
        out, syncs = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        busy, launches, top, _ = device_profile(
            lambda: syncs.append(host_syncs(lambda: out.append(fn()))),
            host_ops=False)
        profiles[name] = {"instrumented_wall_us":
                          1e6 * (time.perf_counter() - t0),
                          "device_busy_us": busy,
                          "device_launches": launches,
                          "host_syncs": syncs[0],
                          "top_kernels_us_count": top}
        return out[0]

    args = mas.make_args(**{**MVF_SCALE, **overrides}, device=device,
                         dtype=dtype)
    res = mas.run_at_scale(args, profile_frame=MVF_PROFILE_FRAME,
                           profiler=profiler)
    for name, prof in profiles.items():
        if name == "place_recognition":
            # its one uninstrumented run, each stage synchronized
            st = res["place_recognition"]["stage_ms"]
            wall_us = 1e3 * (st["describe_ms"] + st["match_ms"]
                             + st["ransac_ms"])
            prof.update(wall_us_uninstrumented=wall_us,
                        idle_share=1.0 - prof["device_busy_us"] / wall_us)
            continue
        near = [s for f, s in res["stage_s"][name]
                if f != MVF_PROFILE_FRAME and abs(f - MVF_PROFILE_FRAME) <= 25]
        wall_us = 1e6 * float(np.median(near))
        prof.update(wall_us_nearby_median=wall_us,
                    idle_share=1.0 - prof["device_busy_us"] / wall_us)
    stage_s = res.pop("stage_s")
    res["stage_ms_median"] = {k: 1e3 * float(np.median([s for _, s in v]))
                              for k, v in stage_s.items() if v}
    prof = res.pop("ba_profile")
    res["ba_phases_s"] = {k: {n: v[n] for n in ("build", "compute",
                                                 "readback", "runs")}
                          for k, v in prof.items()}
    res["ba_log_tail"] = res.pop("ba_log")[-3:]
    res["profiled_frame"] = MVF_PROFILE_FRAME
    res["profiles"] = profiles
    return res


def two_view_inputs(seed=TWO_VIEW["seed"]) -> dict:
    """The two-view phase's host float64 inputs: the pair's pixels (inliers
    projected with noise, outliers uniform in the second image), the GT
    motion, each image's Hartley normalization of its points, the RANSAC
    samples (from CPU generators, so the card and the CPU fit the same
    hypotheses), and the plane and rotation homographies."""
    import torch
    from surikatoko_tpu_torch.geom import so3
    from surikatoko_tpu_torch.models.sfm.ransac import draw_samples
    rng = np.random.default_rng(seed)
    n, W, H = TWO_VIEW["n"], 640, 480
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    R = so3.exp(torch.tensor([0.05, -0.12, 0.03], dtype=torch.float64)).numpy()
    t = np.array([0.4, -0.1, 0.15])
    uv = np.stack([rng.uniform(0, W, 4 * n), rng.uniform(0, H, 4 * n),
                   np.ones(4 * n)], 1)
    X = (uv @ np.linalg.inv(K).T) * rng.uniform(3.0, 8.0, (4 * n, 1))
    p2 = (X @ R.T + t) @ K.T
    p2 = p2[:, :2] / p2[:, 2:]
    inside = (p2[:, 0] >= 0) & (p2[:, 0] < W) & (p2[:, 1] >= 0) & (p2[:, 1] < H)
    x1 = uv[inside][:n, :2] + rng.normal(scale=TWO_VIEW["noise_px"], size=(n, 2))
    x2 = p2[inside][:n] + rng.normal(scale=TWO_VIEW["noise_px"], size=(n, 2))
    out = rng.choice(n, int(TWO_VIEW["outlier_share"] * n), replace=False)
    x2[out] = np.stack([rng.uniform(0, W, out.size),
                        rng.uniform(0, H, out.size)], 1)

    def hartley(x):
        mean = x.mean(0)
        s = np.sqrt(2.0) / np.mean(np.linalg.norm(x - mean, axis=1))
        return (x - mean) * s, s

    u1, s1 = hartley(x1)
    u2, s2 = hartley(x2)
    K_inv = np.linalg.inv(K)
    k1 = x1 @ K_inv[:2, :2].T + K_inv[:2, 2]
    k2 = x2 @ K_inv[:2, :2].T + K_inv[:2, 2]
    Hz, Hr = [], []
    for _ in range(TWO_VIEW["homographies"]):
        Rz = so3.exp(torch.as_tensor(rng.normal(scale=0.35, size=3))).numpy()
        tz = np.array([rng.normal(scale=0.3), rng.normal(scale=0.3),
                       3.0 + rng.normal(scale=0.3)])
        Hp = K @ np.stack([Rz[:, 0], Rz[:, 1], tz], axis=1)
        Hz.append(Hp / Hp[2, 2])
        Rr = so3.exp(torch.as_tensor(rng.normal(scale=0.4, size=3))).numpy()
        Hr.append(K @ Rr @ K_inv)
    gen = lambda k: torch.Generator().manual_seed(seed + k)
    M = TWO_VIEW["hypotheses"]
    return {"K": K, "R": R, "t": t / np.linalg.norm(t), "outliers": out,
            "u1": u1, "u2": u2, "thr_F": (TWO_VIEW["thresh_px"] * s1) ** 2,
            "k1": k1, "k2": k2, "thr_E": (TWO_VIEW["thresh_px"] / 500.0) ** 2,
            "Hz": np.stack(Hz), "Hr": np.stack(Hr),
            "samples_F": draw_samples(gen(1), n, 7, M),
            "samples_E": draw_samples(gen(2), n, 5, M)}


def two_view_steps(inp: dict, device, dtype) -> dict:
    """The two-view toolbox's steps on ``device`` in ``dtype``, each a
    function of the earlier steps' outputs (in order): F by 7-point RANSAC
    with its candidates, the 8-point refit on its inliers, E by 5-point
    RANSAC, the relative pose on E's inliers (8-point, cheirality, Sampson
    polish), the optimal correction of E's inliers, Zhang's and the
    rotating camera's calibrations."""
    import torch
    from surikatoko_tpu_torch.models.sfm import (
        autocalib, five_point, mvg, optimal_triangulation, ransac)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    u1, u2, k1, k2 = (T(inp[k]) for k in ("u1", "u2", "k1", "k2"))
    Hz, Hr = T(inp["Hz"]), T(inp["Hr"])
    n = u1.shape[0]
    every = torch.ones(n, dtype=torch.bool, device=device)
    sF, sE = inp["samples_F"].to(device), inp["samples_E"].to(device)
    return {
        "F7_ransac": lambda o: ransac.ransac(
            n, 7, lambda i: mvg.fundamental_7point(u1[i], u2[i]),
            lambda F: mvg.sampson_distance_sq(F, u1, u2), inp["thr_F"],
            samples=sF, candidates_axis=True),
        "F8_refit": lambda o: mvg.fundamental_8point(
            u1, u2, o["F7_ransac"].inliers),
        "E5_ransac": lambda o: ransac.ransac(
            n, 5, lambda i: five_point.five_point_best(k1[i], k2[i], k1, k2,
                                                       every),
            lambda E: mvg.sampson_distance_sq(E, k1, k2), inp["thr_E"],
            samples=sE),
        "relative_pose": lambda o: mvg.relative_pose_from_correspondences(
            k1, k2, o["E5_ransac"].inliers),
        "optimal_correction": lambda o: optimal_triangulation
        .correct_correspondences_batch(o["E5_ransac"].model,
                                       k1[o["E5_ransac"].inliers],
                                       k2[o["E5_ransac"].inliers]),
        "calib_zhang": lambda o: autocalib.calibrate_from_homographies(Hz),
        "calib_rotation": lambda o: autocalib
        .calibrate_from_rotation_homographies(Hr)}


def two_view_run(inp: dict, device, dtype, reps: int = 0):
    """Every step once in order ({step: output}); with ``reps``, each also
    timed by CUDA events over ``reps`` calls ({step: ms})."""
    outs, ms = {}, {}
    for name, fn in two_view_steps(inp, device, dtype).items():
        outs[name] = fn(outs)
        if reps:
            ms[name] = cuda_ms(lambda: fn(outs), reps)
    return outs, ms


def two_view_host(outs: dict) -> dict:
    """The outputs as float64 host arrays."""
    h = lambda x: x.detach().cpu().numpy().astype(np.float64)
    return {"F": h(outs["F8_refit"]),
            "F_inliers": h(outs["F7_ransac"].inliers),
            "E": h(outs["E5_ransac"].model),
            "E_inliers": h(outs["E5_ransac"].inliers),
            "R": h(outs["relative_pose"].R), "t": h(outs["relative_pose"].t),
            "x1c": h(outs["optimal_correction"][0]),
            "x2c": h(outs["optimal_correction"][1]),
            "K_zhang": h(outs["calib_zhang"]),
            "K_rotation": h(outs["calib_rotation"])}


def two_view_diff(a: dict, b: dict) -> dict:
    """Max |difference| per output of two runs on the same samples: F and E
    up to sign, K relative to its largest entry, inlier masks as the count
    that differ."""
    d = {}
    for k in a:
        x, y = a[k], b[k]
        if k.endswith("inliers"):
            d[k] = float(np.sum(x != y))
        elif x.shape != y.shape:
            d[k] = float("inf")
        elif k in ("F", "E"):
            d[k] = float(min(np.abs(x - y).max(), np.abs(x + y).max()))
        else:
            d[k] = float(np.abs(x - y).max() / (np.abs(y).max()
                                                 if k.startswith("K") else 1.0))
    return d


def two_view_quality(inp: dict, host: dict) -> dict:
    """Rotation error (deg) and translation direction error of the relative
    pose, the inlier counts against the true inliers, the calibrations'
    relative error."""
    true_in = np.ones(TWO_VIEW["n"], bool)
    true_in[inp["outliers"]] = False
    cosang = (np.trace(host["R"] @ inp["R"].T) - 1) / 2
    K = inp["K"]
    return {"rotation_err_deg": float(np.degrees(np.arccos(np.clip(cosang, -1, 1)))),
            "t_dir_err": float(np.linalg.norm(host["t"] - inp["t"])),
            "true_inliers": int(true_in.sum()),
            **{f"{m}_inliers": int(host[f"{m}_inliers"].sum()) for m in "FE"},
            **{f"{m}_outliers_admitted": int(host[f"{m}_inliers"][~true_in].sum())
               for m in "FE"},
            **{k: float(np.abs(host[k] - K).max() / K.max())
               for k in ("K_zhang", "K_rotation")}}


def batch_downdate_case(B, D, m, device, dtype):
    """B random problems of downdate_case's kind: symmetric PSD P [B,D,D],
    M [B,m,D] and a 0/1 keep [B,D] of ~5% zeros."""
    import torch
    g = torch.Generator(device=device).manual_seed(B * 1000 + D * 7 + m)
    A = torch.randn(B, D, D, generator=g, device=device, dtype=dtype)
    P = A @ A.mT / D
    P = torch.tril(P) + torch.tril(P, -1).mT
    M = 0.05 * torch.randn(B, m, D, generator=g, device=device, dtype=dtype)
    keep = (torch.rand(B, D, generator=g, device=device, dtype=dtype)
            > 0.05).to(dtype)
    return P, M, keep


def compare_downdate_batched(cov, P, M, keep):
    """The batched kernel at P [B,D,D], M [B,m,D], keep [B,D] against the
    plain version (each slice held as in compare_downdate, or in float64 as
    in compare_downdate_f64) and against B unbatched kernel calls. Returns
    (max |diff| or max relative Frobenius difference, checks)."""
    import torch
    got = cov.symmetric_downdate(P, M, keep)
    again = cov.symmetric_downdate(P, M, keep)
    vmapped = torch.func.vmap(cov.symmetric_downdate)(P, M, keep)
    shared = torch.func.vmap(cov.symmetric_downdate, in_dims=(None, 0, None))(
        P[0], M, keep[0])
    want = cov.symmetric_downdate_ref(P, M, keep)
    ones = [cov.symmetric_downdate(P[b], M[b], keep[b]) for b in range(len(P))]
    shared_ones = [cov.symmetric_downdate(P[0], M[b], keep[0])
                   for b in range(len(P))]
    if P.dtype == torch.float64:
        err = max(float(torch.linalg.norm(got[b] - want[b])
                        / torch.linalg.norm(want[b])) for b in range(len(P)))
        within = err <= F64_REL_FRO
    else:
        Mk = (M * keep[:, None, :]).abs()
        bound = 1e-5 * (P.abs() * (keep[:, :, None] * keep[:, None, :])
                        + Mk.mT @ Mk) + 1e-30
        diff = (got - want).abs()
        err, within = float(diff.max()), bool((diff <= bound).all())
    checks = {"within_tolerance_of_plain": within,
              "finite": bool(torch.isfinite(got).all()),
              "bitwise_symmetric": torch.equal(got, got.mT),
              "repeats_bitwise": torch.equal(got, again),
              "slices_equal_unbatched_calls": all(
                  torch.equal(got[b], o) for b, o in enumerate(ones)),
              "vmap_equals_batched_call": torch.equal(vmapped, got),
              "shared_P_keep_equal_unbatched_calls": all(
                  torch.equal(shared[b], o) for b, o in enumerate(shared_ones))}
    return err, checks


def batch_downdate_phase(cov, device, fma_per_s, f64_fma_per_s) -> dict:
    """Kernel B2's batched entry points: every BATCH_DOWNDATE_SHAPES case
    in both types checked (compare_downdate_batched), and at the first
    shape the batched call, its B unbatched calls and a batched masked
    baddbmm (the one-call yardstick) timed by CUDA events, graph replay and
    device time, beside the bound."""
    import torch
    out = {"cases": [], "timed": {}}
    for dtype in (torch.float32, torch.float64):
        for B, D, m in BATCH_DOWNDATE_SHAPES:
            P, M, keep = batch_downdate_case(B, D, m, device, dtype)
            err, checks = compare_downdate_batched(cov, P, M, keep)
            case = {"dtype": str(dtype).replace("torch.", ""), "B": B, "D": D,
                    "m": m, "err": err, "checks": checks}
            out["cases"].append(case)
            if not all(checks.values()):
                raise AssertionError(f"batched downdate: {case}")
            if (B, D, m) != BATCH_DOWNDATE_SHAPES[0]:
                continue
            Mk = M * keep[:, None, :]
            fns = {"batched": lambda: cov.symmetric_downdate(P, M, keep),
                   "unbatched_calls": lambda: [
                       cov.symmetric_downdate(P[b], M[b], keep[b])
                       for b in range(B)],
                   "baddbmm": lambda: torch.baddbmm(
                       P * (keep[:, :, None] * keep[:, None, :]), Mk.mT, Mk,
                       alpha=-1),
                   "plain": lambda: cov.symmetric_downdate_ref(P, M, keep)}
            tm = {k: [] for k in fns}
            for name in ("plain", "batched", "unbatched_calls", "baddbmm",
                         "baddbmm", "unbatched_calls", "batched", "plain"):
                tm[name].append(cuda_ms(fns[name], 100))
            f64 = dtype == torch.float64
            fma, nbytes = downdate_work(D, m, True)
            b_ms, b_by = bound_ms(B * fma, B * nbytes * (2 if f64 else 1),
                                  f64_fma_per_s if f64 else fma_per_s)
            graph = {k: cuda_graph_ms(fns[k], 20) for k in fns}
            dev_us = {k: device_us_per_call(fns[k]) for k in fns}
            out["timed"][case["dtype"]] = {
                "B": B, "D": D, "m": m, "ms": tm, "graph_ms": graph,
                "device_us": dev_us, "fma": B * fma,
                "bytes": B * nbytes * (2 if f64 else 1), "bound_ms": b_ms,
                "bound_by": b_by,
                "pct_of_bound_device": 100.0 * b_ms / (1e-3 * dev_us["batched"]),
                "batched_vs_unbatched_device": dev_us["unbatched_calls"]
                / dev_us["batched"]}
    return out


def batch_scan_noise(device, dtype, ate_noise):
    """[BATCH_SCAN_B, 300, K, 2] standard-normal detection noise: instance
    0 takes scenario03's own (``ate_noise``), the others default_rng(
    BATCH_SEED)'s."""
    import torch
    rng = np.random.default_rng(BATCH_SEED)
    rest = rng.standard_normal((BATCH_SCAN_B - 1, *ate_noise.shape))
    return torch.cat([ate_noise[None].to(dtype),
                      torch.as_tensor(rest, dtype=dtype, device=device)])


def batch_scan_phase(ncc, cov, device) -> dict:
    """The scan runner over noise seeds (scenario03's world, impl 1):
    BATCH_SCAN_B instances in float32 over frames 1-300 as one batch, the
    same instances one after another over frames 1-30, one profiled frame
    of each kind, the per-instance health and ATE, and float64 at
    BATCH_F64 instances on the card against the CPU."""
    import torch
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    from surikatoko_tpu_torch.world.device_runner import (
        make_batched_scan_runner, make_scan_runner)
    params, sc, state, ate_noise, _ = scenario03_setup(device, torch.float32)
    noise = batch_scan_noise(device, torch.float32, ate_noise)
    B, T = BATCH_SCAN_B, len(BATCH_SCAN_FRAMES)
    run_b = make_batched_scan_runner(params, 1)
    run_1 = make_scan_runner(params, 1)
    run_b(state, sc, range(1, 4), noise[:, :3])        # warm-up
    torch.cuda.synchronize()
    ncc.LAUNCHES = cov.LAUNCHES = 0
    t0 = time.perf_counter()
    st_b, errs_b, n_b, pos_b, info_b = run_b(state, sc, BATCH_SCAN_FRAMES, noise)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    launches = {"ncc_search": ncc.LAUNCHES, "symmetric_downdate": cov.LAUNCHES}
    n_seq = len(BATCH_SEQ_FRAMES)
    run_1(state, sc, range(1, 4), noise[0, :3])          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = [run_1(state, sc, BATCH_SEQ_FRAMES, noise[b, :n_seq]) for b in range(B)]
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    frame = BATCH_SCAN_FRAMES[-1] + 1
    busy_b, nl_b, top_b, by_b = profiled(
        lambda: run_b(st_b, sc, [frame], noise[:, :1]))
    busy_1, nl_1, _, by_1 = profiled(
        lambda: run_1(seq[0][0], sc, [n_seq + 1], noise[0, :1]))
    wall_b, wall_1 = 1e6 * t_batched / T, 1e6 * t_seq / (B * n_seq)
    frame_without_host_sync(run_b, st_b, sc, [frame], noise[:, :1])
    gt = gt_positions(sc, BATCH_SCAN_FRAMES).double()
    gt_seq = gt[:n_seq]
    ate_b = [float(aligned_rmse(pos_b[b].double(), gt)) for b in range(B)]
    ate_b30 = [float(aligned_rmse(pos_b[b, :n_seq].double(), gt_seq))
               for b in range(B)]
    ate_s30 = [float(aligned_rmse(o[3].double(), gt_seq)) for o in seq]
    # float64: BATCH_F64 instances on the card against their unbatched runs
    # on the CPU
    p64, sc64, st64, ate64, _ = scenario03_setup(device, torch.float64)
    out64 = make_batched_scan_runner(p64, 1)(
        st64, sc64, BATCH_SEQ_FRAMES,
        batch_scan_noise(device, torch.float64, ate64)[:BATCH_F64, :n_seq])
    f64_sym = torch.equal(out64[0].P, out64[0].P.mT)
    cpu = torch.device("cpu")
    p64, sc64, st64, ate64, _ = scenario03_setup(cpu, torch.float64)
    nz = batch_scan_noise(cpu, torch.float64, ate64)[:BATCH_F64, :n_seq]
    run64 = make_scan_runner(p64, 1)
    pos64 = {"card": out64[3].cpu(),
             "cpu": torch.stack([run64(st64, sc64, BATCH_SEQ_FRAMES, nz[b])[3]
                                 for b in range(BATCH_F64)])}
    diff64 = float((pos64["card"] - pos64["cpu"]).abs().max())
    out = {
        "B": B, "K": SC03_K, "D": int(state.x.shape[0]), "update_impl": 1,
        "frames": T, "batched_s": t_batched,
        "instance_frames_per_s_batched": B * T / t_batched,
        "sequential_frames": n_seq, "sequential_s": t_seq,
        "instance_frames_per_s_sequential": B * n_seq / t_seq,
        "speedup": (B * T / t_batched) / (B * n_seq / t_seq),
        "launches": launches,
        "profile_frame": {
            "batched": {"device_busy_us": busy_b, "device_launches": nl_b,
                        "wall_us": wall_b, "busy_share": busy_b / wall_b,
                        "symmetric_downdate_us_launches": kernel_share(
                            by_b, DOWNDATE_DEVICE_KERNELS),
                        "top_kernels_us_count": top_b},
            "unbatched": {"device_busy_us": busy_1, "device_launches": nl_1,
                          "wall_us": wall_1, "busy_share": busy_1 / wall_1,
                          "symmetric_downdate_us_launches": kernel_share(
                              by_1, DOWNDATE_DEVICE_KERNELS)}},
        "ate_median": float(np.median(ate_b)), "ate_max": float(np.max(ate_b)),
        "ate_instance0": ate_b[0],
        "ate30_batched_vs_unbatched_max_abs_diff": float(np.max(np.abs(
            np.array(ate_b30) - np.array(ate_s30)))),
        "cam_pos30_batched_vs_unbatched_max_abs_diff": max(
            float((pos_b[b, :n_seq] - o[3]).abs().max()) for b, o in enumerate(seq)),
        # the closest that an instance's unbatched positions come to
        # another instance's batched ones
        "cam_pos30_other_instance_min_max_abs_diff": min(
            float((pos_b[c, :n_seq] - o[3]).abs().max())
            for b, o in enumerate(seq) for c in range(B) if c != b),
        "f64": {"B": BATCH_F64, "frames": n_seq,
                "cam_pos_card_vs_cpu_max_abs_diff": diff64,
                "tol": F64_CAM_TOL}}
    out["checks"] = {
        "finite": bool(torch.isfinite(st_b.x).all() and torch.isfinite(st_b.P).all()
                       and torch.isfinite(errs_b).all()),
        "P_exactly_symmetric": torch.equal(st_b.P, st_b.P.mT),
        "chol_info_zero_every_frame": int(torch.count_nonzero(info_b)) == 0,
        "one_downdate_launch_a_frame": launches == {"ncc_search": 0,
                                                    "symmetric_downdate": T},
        "ate30_within": out["ate30_batched_vs_unbatched_max_abs_diff"]
        <= BATCH_F32_ATE_TOL,
        "cam_pos30_within": out["cam_pos30_batched_vs_unbatched_max_abs_diff"]
        <= BATCH_F32_CAM_TOL,
        "cam_pos30_instances_apart": out[
            "cam_pos30_other_instance_min_max_abs_diff"] > BATCH_F32_CAM_TOL,
        "f64_card_vs_cpu_within": diff64 <= F64_CAM_TOL and f64_sym,
        "instances_differ": float(pos_b[:, -1].std(dim=0).max()) > 0,
        # frame_without_host_sync above raised on any sync
        "batched_frame_free_of_host_syncs": True}
    return out


def batch_ba_phase(device) -> dict:
    """Batch BA (demos.batch_ba's problems and flow) at BATCH_BA_SIZES in
    float64 and float32: problems/s batched, and for the first BATCH_BA_SEQ
    problems one after another (BundleAdjustment(device_loop=True), the
    same program for one problem); converged counts; the batch's outer and
    trial rounds (each one set of launches for all problems); in float64
    each of those problems' stop code, iterations and trials against its
    own run; one profiled LM iteration of the batch."""
    import torch
    from surikatoko_tpu_torch.demos import batch_ba
    from surikatoko_tpu_torch.models.ba import BundleAdjustment, TermCriteria
    from surikatoko_tpu_torch.interop import stack
    out = {}
    for f32 in (False, True):
        name = "float32" if f32 else "float64"
        res = {}
        for B in BATCH_BA_SIZES:
            r = batch_ba.run(batch_ba.make_args(
                batch=B, f32=f32, device=device,
                compare_sequential=B == BATCH_BA_SEQ), log=lambda *_: None)
            r["path"] = [list(x) for x in zip(r.pop("codes"), r.pop("iters"),
                                              r.pop("trials"))]
            if "sequential_path" in r:
                res["sequential_path"] = r.pop("sequential_path")
            res[B] = r
        # each problem's decisions in every batch against its own run
        res["same_decisions_as_alone"] = {
            B: res[B]["path"][:BATCH_BA_SEQ] == res["sequential_path"]
            for B in BATCH_BA_SIZES}
        out[name] = res
    # one LM iteration of the largest batch under the profiler, beside the
    # same call's wall time
    args = batch_ba.make_args(batch=BATCH_BA_SIZES[-1], f32=True, device=device)
    batch = stack(batch_ba.problems(args))
    one = TermCriteria(allowed_reproj_err_rel_change=args.allowed_repr_err,
                       max_iters=1)
    ba = BundleAdjustment(device_loop=True)
    ba.compute_batched(batch, one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds = ba.compute_batched(batch, one).trial_rounds
    torch.cuda.synchronize()
    wall = 1e6 * (time.perf_counter() - t0)
    busy, nl, top, _ = profiled(lambda: ba.compute_batched(batch, one))
    out["profile_iteration"] = {
        "B": BATCH_BA_SIZES[-1], "dtype": "float32",
        "trial_rounds": rounds, "wall_us": wall,
        "device_busy_us": busy, "device_launches": nl,
        "busy_share": busy / wall, "top_kernels_us_count": top}
    return out


def demo_run(device, x64: bool) -> dict:
    """The MonoSlam demo's main path, DEMO_FRAMES frames of DEMO_CONFIG,
    no views and no internals file; its metrics."""
    from surikatoko_tpu_torch.demos import davison_mono_slam as demo
    return demo.run(demo.make_args(
        scene_config=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  DEMO_CONFIG),
        frames=DEMO_FRAMES, device=str(device), x64=x64, out_internals=""),
        log=lambda *a: None)


def demo_ate(device="cpu") -> float:
    return demo_run(device, True)["ate_rmse"]


def slab_work(R: int, D: int, m: int) -> tuple[float, float]:
    """(FMAs, values moved) of a row slab with keep: R (D - R) m FMAs for
    the columns outside its rows and R (R + 1) / 2 m for the symmetric
    block inside them (each of its pairs one m-long product); P's rows, M
    and keep read once, the [R,D] output written."""
    return (float(R * (D - R) * m + R * (R + 1) // 2 * m),
            float(2 * R * D + m * D + D))


def slab_phase(cov, device, fma_per_s, f64_fma_per_s) -> dict:
    """Kernel B2's row-slab entry points at SLAB_SHAPES, float32 and
    float64, random symmetric P and a keep of ~5% zeros: bit for bit the
    full call's rows, repeating, within the plain version's tolerance
    (float32: compare_downdate's; float64: F64_REL_FRO), timed by events,
    graph replay and device time beside the plain version, a masked addmm
    of the same rows (its one-call yardstick) and the bound."""
    import torch
    cases, timed = [], {}
    for dtype in (torch.float32, torch.float64):
        for R, D, m, r0 in SLAB_SHAPES:
            P, M, keep = downdate_case(D, m, True, device, dtype)
            Pr = P[r0:r0 + R].contiguous()
            Mk = M * keep[None, :]
            fns = {"kernel": lambda: cov.symmetric_downdate_rows(Pr, M, keep, r0),
                   "plain": lambda: cov.symmetric_downdate_rows_ref(Pr, M, keep, r0),
                   "addmm": lambda: torch.addmm(
                       Pr * (keep[r0:r0 + R, None] * keep[None, :]),
                       Mk[:, r0:r0 + R].T, Mk, alpha=-1)}
            got, again, want = fns["kernel"](), fns["kernel"](), fns["plain"]()
            full = cov.symmetric_downdate(P, M, keep)[r0:r0 + R]
            diff = (got - want).abs()
            if dtype == torch.float32:
                bound = 1e-5 * (Pr.abs() * (keep[r0:r0 + R, None] * keep[None, :])
                                + Mk[:, r0:r0 + R].abs().T @ Mk.abs()) + 1e-30
                within = bool((diff <= bound).all())
            else:
                within = float(torch.linalg.norm(got - want)
                               / torch.linalg.norm(want)) <= F64_REL_FRO
            case = {"dtype": str(dtype).split(".")[-1], "R": R, "D": D, "m": m,
                    "r0": r0, "max_abs_err": float(diff.max()),
                    "bitwise_full": bool(torch.equal(got, full)),
                    "repeats": bool(torch.equal(got, again)),
                    "within_tolerance": within,
                    "form_width_blocks": cov.rows_config(
                        D, R, r0, dtype, cov.sm_count(device))}
            cases.append(case)
            if not (case["bitwise_full"] and case["repeats"] and within
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"slab kernel: {case}")
            n = 20
            tm = {k: [] for k in fns}
            for name in ("plain", "kernel", "addmm", "addmm", "kernel", "plain"):
                tm[name].append(cuda_ms(fns[name], n))
            tm["graph_ms"] = {k: cuda_graph_ms(fns[k], 5) for k in fns}
            fma, vals = slab_work(R, D, m)
            b_ms, b_by = bound_ms(fma, vals * got.element_size(),
                                  fma_per_s if dtype == torch.float32
                                  else f64_fma_per_s)
            kern_ms = float(np.mean(tm["kernel"]))
            tm.update(kernel_device_us=device_us_per_call(fns["kernel"]),
                      addmm_device_us=device_us_per_call(fns["addmm"]),
                      form_width_blocks=case["form_width_blocks"],
                      bound_ms=b_ms, bound_by=b_by, fma=fma,
                      pct_of_bound=100.0 * b_ms / kern_ms,
                      pct_of_bound_graph=100.0 * b_ms / tm["graph_ms"]["kernel"])
            timed[f"{case['dtype']}_{R}x{D}x{m}_r{r0}"] = tm
    return {"cases": cases, "timed": timed}


def slab_report(tm: dict) -> dict:
    """One slab shape's line in the kernels report: form and grid, the
    kernel's ms by events, graph replay and device time, its bound, the
    plain version's and the masked addmm's times, and whether the kernel
    beat the addmm by both graph replay and device time."""
    ms = float(np.mean(tm["kernel"]))
    return {"form_width_blocks": list(tm["form_width_blocks"]), "ms": ms,
            "graph_ms": tm["graph_ms"]["kernel"],
            "device_us": tm["kernel_device_us"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "pct_of_bound": tm["pct_of_bound"],
            "pct_of_bound_graph": tm["pct_of_bound_graph"],
            "plain_ms": float(np.mean(tm["plain"])),
            "library_ms": float(np.mean(tm["addmm"])),
            "library_graph_ms": tm["graph_ms"]["addmm"],
            "library_device_us": tm["addmm_device_us"],
            "faster_than_library": bool(
                tm["graph_ms"]["kernel"] < tm["graph_ms"]["addmm"]
                and tm["kernel_device_us"] < tm["addmm_device_us"])}


def sharded_phase(device) -> dict:
    """The distribution layer on a one-rank NCCL group (one card):
    parity.sharded_parity at K=768 (the sharded fused step in float64 and
    float32 against the single-device step, its camera-row and own-row
    slabs bit for bit the full B2 call's; the sharded imageseq runner with
    bench.py:355-358's settings against make_imageseq_scan_runner over
    frames 1-8, launches, fps over 9-40, one profiled frame; the banded
    point-sharded BA at 2048 x 100), dryrun_multichip(1) in ranks of its
    own, and the MonoSlam demo's main path in float64 and float32."""
    import torch.distributed as dist
    from surikatoko_tpu_torch.parallel import dryrun, launch, parity

    def profile(fn):
        busy, n_dev, top, _ = profiled(fn)
        return {"device_busy_us": busy, "device_launches": n_dev,
                "top_kernels_us_count": top}

    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{launch.free_port()}",
        world_size=1, rank=0)
    try:
        out = parity.sharded_parity(
            device=device, capacity=K_FLAGSHIP, frames=SHARDED_FRAMES,
            timed=SHARDED_TIMED, ba_size=SHARDED_BA, profile=profile)
    finally:
        dist.destroy_process_group()
    im = out["imageseq"]
    im["busy_share"] = im["profile"]["device_busy_us"] / (
        1e3 * im["wall_ms_per_frame"])
    checks = out["checks"]

    # (d) the dry run in ranks of its own
    t0 = time.perf_counter()
    out["dryrun"] = dryrun.dryrun_multichip(1)
    out["dryrun"]["wall_s"] = time.perf_counter() - t0

    # (f) the MonoSlam demo's main path, float64 (its default) and float32
    for x64, name in ((True, "float64"), (False, "float32")):
        demo_run(device, x64)                           # warm-up
        m = demo_run(device, x64)
        out[f"demo_{name}"] = {k: m[k] for k in (
            "frames", "dtype", "fps", "avg_frame_ms", "wall_s", "ate_rmse",
            "estimated_count", "finite")}
    d64, d32 = out["demo_float64"], out["demo_float32"]
    checks.update(
        demo_frames=d64["frames"] == d32["frames"] == DEMO_FRAMES,
        demo_finite=d64["finite"] and d32["finite"],
        demo_f64_ate_as_cpu=abs(d64["ate_rmse"] - DEMO_ATE_F64) <= 1e-6,
        demo_f32_ate=d32["ate_rmse"] <= 2 * DEMO_ATE_F64 + 0.02)
    out["checks"] = checks
    return out


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
    f64_fma_per_s = n_sm * F64_FMA_PER_SM_CLOCK * clock_mhz * 1e6
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
          "f32_fma_per_s": fma_per_s, "f64_fma_per_s": f64_fma_per_s,
          "hbm_bytes_per_s": HBM_BYTES_PER_S})

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
            if not ok:
                raise AssertionError(f"kernel disagrees with plain: {cases[-1]}")
    for name in NCC_EDGE_CASES:
        p, t, g = (torch.as_tensor(a, device=device)
                   for a in ncc_edge_case(name, rng))
        for with_neigh in (False, True):
            err, agree, ok, nerr = compare(ncc_cuda, p, t, g, with_neigh)
            cases.append({"case": name, "K": g.shape[0], "T": t.shape[-1],
                          "S": g.shape[-1], "with_neigh": with_neigh,
                          "max_abs_err": err, "idx_agreement": agree,
                          "neigh_max_abs_err": nerr})
            if not (ok and (agree == 1.0 or name == "ragged")):
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
    ncc_graph_ms = {"kernel": cuda_graph_ms(kern, reps),
                    "plain": cuda_graph_ms(plain, reps // 4)}
    ncc_bound, ncc_bound_by = bound_ms(*ncc_work(fp, ft, fg), fma_per_s)
    ncc_device_us = device_us_per_call(kern)
    # the image loop's shapes, random data: a launch-bound call
    ncc_imseq = {}
    for K, T, S in IMSEQ_SHAPES:
        ip, it_, ig = random_case(np.random.default_rng(K), K, T, S, device)
        ik = lambda: ncc_cuda.ncc_surface_argmax(ip, it_, ig)
        ipl = lambda: ncc_cuda.ncc_surface_argmax_ref(ip, it_, ig)
        b_ms, b_by = bound_ms(*ncc_work(ip, it_, ig), fma_per_s)
        g_ms = cuda_graph_ms(ik, reps)
        ncc_imseq[f"{K}x{T}x{S}"] = {
            "K": K, "T": T, "S": S, "kernel_ms": cuda_ms(ik, reps),
            "plain_ms": cuda_ms(ipl, reps // 4), "graph_ms": g_ms,
            "plain_graph_ms": cuda_graph_ms(ipl, reps // 4),
            "kernel_device_us": device_us_per_call(ik),
            "bound_ms": b_ms, "bound_by": b_by, "fma": ncc_work(ip, it_, ig)[0],
            "bytes": ncc_work(ip, it_, ig)[1],
            "pct_of_bound": 100.0 * b_ms / g_ms}

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
    # the float64 entry point: every shape against the plain version in
    # float64 on the card; timed with keep at the main-path shapes
    dd64_cases, dd64_times = [], {}
    for D, m in DOWNDATE_SHAPES:
        for with_keep in (False, True):
            P, M, keep = downdate_case(D, m, with_keep, device, torch.float64)
            rel, ok = compare_downdate_f64(covariance, P, M, keep)
            dd64_cases.append({"D": D, "m": m, "keep": with_keep,
                               "rel_fro": rel})
            if not ok:
                raise AssertionError(f"float64 downdate kernel disagrees with "
                                     f"plain or is not symmetric: {dd64_cases[-1]}")
            if with_keep and (D, m) in DOWNDATE_TIMED:
                Mk = M * keep[None, :]
                fns = {"kernel": lambda: covariance.symmetric_downdate(P, M, keep),
                       "plain": lambda: covariance.symmetric_downdate_ref(P, M, keep),
                       "addmm": lambda: torch.addmm(
                           P * (keep[:, None] * keep[None, :]), Mk.T, Mk, alpha=-1)}
                n = 200 if D < 1000 else 20
                tm = {k: [] for k in fns}
                for name in ("plain", "kernel", "addmm", "addmm", "kernel", "plain"):
                    tm[name].append(cuda_ms(fns[name], n))
                tm["graph_ms"] = {name: cuda_graph_ms(fns[name], max(n // 4, 5))
                                  for name in fns}
                fma, nbytes = downdate_work(D, m, True)
                b_ms, b_by = bound_ms(fma, 2.0 * nbytes, f64_fma_per_s)
                kern_ms = float(np.mean(tm["kernel"]))
                tm.update(kernel_device_us=device_us_per_call(fns["kernel"]),
                          tile=covariance.downdate_config(D, torch.float64)[0],
                          bound_ms=b_ms, bound_by=b_by,
                          pct_of_bound=100.0 * b_ms / kern_ms)
                dd64_times[f"{D}x{m}"] = tm
    emit({"phase": "kernel",
          "ncc_search": {"cases": cases,
                         "flagship": {"K": K_FLAGSHIP, "T": 15, "S": 15,
                                      "max_abs_err": flag_err,
                                      "idx_agreement": flag_agree,
                                      "kernel_ms": t_kern, "plain_ms": t_plain,
                                      "graph_ms": ncc_graph_ms,
                                      "kernel_device_us": ncc_device_us,
                                      "bound_ms": ncc_bound,
                                      "bound_by": ncc_bound_by,
                                      "pct_of_bound": 100.0 * ncc_bound
                                      / ncc_graph_ms["kernel"]},
                         "imageseq_shapes": ncc_imseq},
          "symmetric_downdate": {"cases": dd_cases, "ms_with_keep": dd_times},
          "symmetric_downdate_f64": {"cases": dd64_cases,
                                     "ms_with_keep": dd64_times,
                                     "rel_fro_bound": F64_REL_FRO}})
    del st0, tm0
    # kernel B2's batched entry points (checked and timed here, where the
    # profiler is fresh: late in the run its device events went missing;
    # reported in the batch_eval phase)
    bdd = batch_downdate_phase(covariance, device, fma_per_s, f64_fma_per_s)
    # kernel B2's row-slab entry points, likewise (reported in the sharded
    # phase)
    slab = slab_phase(covariance, device, fma_per_s, f64_fma_per_s)

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
          "ncc_search_us_launches": kernel_share(by_kernel, NCC_DEVICE_KERNELS),
          "symmetric_downdate_us_launches": kernel_share(by_kernel,
                                                         DOWNDATE_DEVICE_KERNELS),
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
                                kernel_share(by_kernel3, DOWNDATE_DEVICE_KERNELS),
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

    # ---- the host-driven tracker (MonoSlamFilter + GT matcher) ----
    host = {}
    for dtype in (torch.float32, torch.float64):
        run_h, tracker_h = hostloop_runner(device, dtype)
        run_h(HOSTLOOP_WARM)
        torch.cuda.synchronize()
        ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
        t0 = time.perf_counter()
        res_h = run_h(HOSTLOOP_FRAMES)
        torch.cuda.synchronize()
        dt_h = time.perf_counter() - t0
        name = str(dtype).replace("torch.", "")
        host[name] = {**hostloop_summary(res_h), "s": dt_h,
                      "fps": HOSTLOOP_FRAMES / dt_h,
                      "launches": {"ncc_search": ncc_cuda.LAUNCHES,
                                   "symmetric_downdate": covariance.LAUNCHES}}
        if dtype == torch.float32:
            # one more step with every slot matched at its predicted pixel
            # and no recruit, with host syncs raising: the step reads nothing
            st_h = res_h.state
            frame_without_host_sync(
                tracker_h.process_frame, st_h, tracker_h.predicted_pixels(st_h),
                st_h.lm_active, torch.zeros((16, 2), dtype=dtype, device=device),
                torch.zeros(16, dtype=torch.bool, device=device))
            busy_h, nl_h, top_h, by_h = device_profile(
                lambda: run_h(HOSTLOOP_PROFILE))
            wall_us = 1e6 * dt_h / HOSTLOOP_FRAMES
            host[name]["profile"] = {
                "frames": HOSTLOOP_PROFILE,
                "device_busy_us_per_frame": busy_h / HOSTLOOP_PROFILE,
                "device_launches_per_frame": nl_h / HOSTLOOP_PROFILE,
                "wall_us_per_frame": wall_us,
                "device_idle_share": 1.0 - busy_h / HOSTLOOP_PROFILE / wall_us,
                "symmetric_downdate_us_launches": kernel_share(
                    by_h, DOWNDATE_DEVICE_KERNELS),
                "top_kernels_us_count": top_h}
        else:
            res_f64_card = res_h
        del run_h, tracker_h
    res_cpu = hostloop_runner("cpu", torch.float64)[0](HOSTLOOP_CPU)
    cam_diff = max(float((a.cam_state.cpu() - b.cam_state).abs().max())
                   for a, b in zip(res_f64_card.stats, res_cpu.stats))
    counts_equal = all(
        int(getattr(a, k)) == int(getattr(b, k))
        for a, b in zip(res_f64_card.stats, res_cpu.stats)
        for k in ("obs_count", "new_count", "deleted_count"))
    host_bound = 2 * host["float64"]["ate"] + 0.02
    emit({"phase": "hostloop", "K": SC03_K, "D": 13 + 6 * SC03_K,
          "update_impl": 1, "warmup_frames": HOSTLOOP_WARM,
          "process_frame_host_syncs": 0, **host,
          "f64_card_vs_cpu": {"frames": HOSTLOOP_CPU,
                              "cam_state_max_abs_diff": cam_diff,
                              "tol": F64_CAM_TOL, "counts_equal": counts_equal},
          "ate_bound_f32": host_bound})
    for name, h in host.items():
        if not (h["finite"] and h["P_exactly_symmetric"]):
            raise AssertionError(f"hostloop {name}: non-finite or P != P^T")
        if h["launches"] != {"ncc_search": 0,
                             "symmetric_downdate": HOSTLOOP_FRAMES}:
            raise AssertionError(f"hostloop {name}: launches {h['launches']} "
                                 f"for {HOSTLOOP_FRAMES} frames")
    if not (cam_diff <= F64_CAM_TOL and counts_equal):
        raise AssertionError(f"hostloop float64 on the card vs the CPU: "
                             f"cam_state differs by {cam_diff}, counts equal "
                             f"{counts_equal}")
    if not host["float32"]["ate"] <= host_bound:
        raise AssertionError(f"hostloop f32 ATE {host['float32']['ate']} > "
                             f"{host_bound}")
    del res_f64_card, res_cpu, res_h

    # ---- the host-driven image loop (NCC matcher, then KLT) ----
    imseq_dir = tempfile.mkdtemp(prefix="imageseq_")
    t0 = time.perf_counter()
    write_imageseq(imseq_dir)
    t_render = time.perf_counter() - t0
    imseq, t_phase = {}, time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        imageseq_run(imseq_dir, device, dtype, IMSEQ_WARM)     # warm-up
        runs = []
        for _ in range(2):
            ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
            st_i, stats_i, _, native_i, dt_i = imageseq_run(imseq_dir, device,
                                                            dtype)
            runs.append((dt_i, {"ncc_search": ncc_cuda.LAUNCHES,
                                "symmetric_downdate": covariance.LAUNCHES},
                         imageseq_summary(st_i, stats_i), native_i))
        dt_i, launches_i, summ, native_i = min(runs, key=lambda r: r[0])
        t0 = time.perf_counter()
        busy_i, nl_i, top_i, by_i = device_profile(
            lambda: imageseq_run(imseq_dir, device, dtype, IMSEQ_PROFILE),
            host_ops=False)
        t_profile = time.perf_counter() - t0
        syncs = [host_syncs(lambda: imageseq_run(imseq_dir, device, dtype, n))
                 for n in IMSEQ_SYNC_FRAMES]
        stages = imageseq_stages(imseq_dir, device, dtype, IMSEQ_PROFILE)
        wall_us = 1e6 * dt_i / IMSEQ_FRAMES
        imseq[name] = {
            **summ, "native": native_i, "runs_s": [r[0] for r in runs],
            "s": dt_i, "fps": IMSEQ_FRAMES / dt_i,
            "launches": launches_i,
            "launches_each_run": [r[1] for r in runs],
            "host_syncs_per_frame": (syncs[1] - syncs[0])
            / (IMSEQ_SYNC_FRAMES[1] - IMSEQ_SYNC_FRAMES[0]),
            "host_syncs_runs": dict(zip(IMSEQ_SYNC_FRAMES, syncs)),
            "stage_ms_per_frame_synchronized": stages,
            "profile": {
                "frames": IMSEQ_PROFILE, "profile_s": t_profile,
                "device_busy_us_per_frame": busy_i / IMSEQ_PROFILE,
                "device_launches_per_frame": nl_i / IMSEQ_PROFILE,
                "wall_us_per_frame": wall_us,
                "device_idle_share": 1.0 - busy_i / IMSEQ_PROFILE / wall_us,
                "ncc_search_us_launches_per_frame": [
                    v / IMSEQ_PROFILE for v in kernel_share(by_i,
                                                            NCC_DEVICE_KERNELS)],
                "symmetric_downdate_us_launches_per_frame": [
                    v / IMSEQ_PROFILE for v in kernel_share(
                        by_i, DOWNDATE_DEVICE_KERNELS)],
                "top_kernels_us_count": top_i}}
        if not all(r[3] for r in runs):
            raise AssertionError(f"imageseq_hostloop {name}: frames were not "
                                 "decoded by the native loader")
        for _, launches_r, summ_r, _ in runs:
            if not (summ_r["finite"] and summ_r["P_exactly_symmetric"]):
                raise AssertionError(f"imageseq_hostloop {name}: non-finite "
                                     f"or P != P^T")
            if launches_r != {"ncc_search": IMSEQ_FRAMES,
                              "symmetric_downdate": IMSEQ_FRAMES}:
                raise AssertionError(f"imageseq_hostloop {name}: launches "
                                     f"{launches_r} for {IMSEQ_FRAMES} frames")
            if not summ_r["obs_count_med"] >= IMSEQ_K / 2:
                raise AssertionError(f"imageseq_hostloop {name}: matched median "
                                     f"{summ_r['obs_count_med']} < K/2")
        del st_i, stats_i, runs
    # float64 on the card against the CPU, frames 0-29, with B1's results
    card = imageseq_run(imseq_dir, device, torch.float64, IMSEQ_CPU, record=True)
    cpu = imageseq_run(imseq_dir, "cpu", torch.float64, IMSEQ_CPU, record=True)
    vs_cpu = imageseq_card_vs_cpu(card[1:3], cpu[1:3], IMSEQ_CPU)
    vs_cpu["cpu_s"] = cpu[4]
    del card, cpu
    # the KLT matcher over 60 frames, float32
    ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
    st_k, stats_k, _, native_k, dt_k = imageseq_run(
        imseq_dir, device, torch.float32, IMSEQ_KLT, klt=True)
    klt = {**imageseq_summary(st_k, stats_k), "native": native_k, "s": dt_k,
           "fps": IMSEQ_KLT / dt_k, **IMSEQ_KLT_KW,
           "launches": {"ncc_search": ncc_cuda.LAUNCHES,
                        "symmetric_downdate": covariance.LAUNCHES}}
    del st_k, stats_k
    imseq_bound = 2 * imseq["float64"]["ate"] + 0.02
    emit({"phase": "imageseq_hostloop", "K": IMSEQ_K, "D": 13 + 6 * IMSEQ_K,
          "phase_s": time.perf_counter() - t_phase + t_render,
          "frames": IMSEQ_FRAMES, "warmup_frames": IMSEQ_WARM,
          "image": [320, 240], "update_impl": 1,
          "matcher": IMSEQ_MATCHER, "render_and_write_s": t_render, **imseq,
          "f64_card_vs_cpu": vs_cpu, "ate_bound_f32": imseq_bound,
          "klt": klt})
    if not imseq["float32"]["ate"] <= imseq_bound:
        raise AssertionError(f"imageseq_hostloop: f32 ATE "
                             f"{imseq['float32']['ate']} > {imseq_bound}")
    if not (klt["finite"] and klt["P_exactly_symmetric"] and klt["native"]):
        raise AssertionError(f"imageseq_hostloop klt: {klt}")
    if klt["launches"] != {"ncc_search": 0, "symmetric_downdate": IMSEQ_KLT}:
        raise AssertionError(f"imageseq_hostloop klt: launches {klt['launches']}")
    if not klt["obs_count_med"] > 0:
        raise AssertionError("imageseq_hostloop klt: nothing matched")
    for f in os.listdir(imseq_dir):
        os.unlink(os.path.join(imseq_dir, f))
    os.rmdir(imseq_dir)

    # ---- scenario03 in float64 on the card against the CPU ----
    pos64 = {}
    for dev in (device, torch.device("cpu")):
        p64, sc64, st64, noise64, _ = scenario03_setup(dev, torch.float64)
        covariance.LAUNCHES = ncc_cuda.LAUNCHES = 0
        out64 = make_scan_runner(p64, 1)(st64, sc64, SC03_F64_FRAMES,
                                         noise64[:len(SC03_F64_FRAMES)])
        pos64[dev.type] = out64[3].cpu()
        if dev.type == "cuda":
            launches64 = {"ncc_search": ncc_cuda.LAUNCHES,
                          "symmetric_downdate": covariance.LAUNCHES}
            card64 = {"P_exactly_symmetric": bool(torch.equal(out64[0].P,
                                                               out64[0].P.T)),
                      "chol_info_nonzero": int(torch.count_nonzero(out64[4])),
                      "finite": bool(torch.isfinite(out64[0].P).all())}
    diff64 = float((pos64["cuda"] - pos64["cpu"]).abs().max())
    emit({"phase": "scenario03_f64", "K": SC03_K, "update_impl": 1,
          "frames": len(SC03_F64_FRAMES), "cam_pos_max_abs_diff": diff64,
          "tol": F64_CAM_TOL, "launches": launches64, **card64})
    if not (diff64 <= F64_CAM_TOL and card64["P_exactly_symmetric"]
            and card64["finite"] and card64["chol_info_nonzero"] == 0):
        raise AssertionError(f"scenario03 float64 on the card: {diff64} from "
                             f"the CPU, {card64}")
    if launches64 != {"ncc_search": 0,
                      "symmetric_downdate": len(SC03_F64_FRAMES)}:
        raise AssertionError(f"scenario03_f64 launches {launches64}")

    # ---- the K=768 f32-vs-f64 pin ----
    pk = {}
    for dtype, mit in ((torch.float64, False), (torch.float32, True)):
        covariance.LAUNCHES = ncc_cuda.LAUNCHES = 0
        r = precision_run(device, dtype, mit, profile=dtype == torch.float64)
        pk[r["dtype"]] = r
    pk_bound = 2 * pk["float64"]["ate"] + 0.02
    emit({"phase": "precision_k768", "K": PK_K, "D": 13 + 6 * PK_K, **pk,
          "ate_bound_f32": pk_bound})
    for name, r in pk.items():
        if not (r["finite"] and r["P_exactly_symmetric"]):
            raise AssertionError(f"precision_k768 {name}: non-finite or P != P^T")
        if not r["matched_med"] > 500:
            raise AssertionError(f"precision_k768 {name}: matched median "
                                 f"{r['matched_med']} <= 500")
        if r["launches"] != {"ncc_search": 0,
                             "symmetric_downdate": len(PK_FRAMES)}:
            raise AssertionError(f"precision_k768 {name}: launches {r['launches']}")
    if not pk["float32"]["ate"] <= pk_bound:
        raise AssertionError(f"precision_k768: f32 ATE {pk['float32']['ate']} > "
                             f"{pk_bound}")

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

    # ---- multi-view factorization: the demo's world, then the 10k x 512
    # pipeline ----
    ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
    t0 = time.perf_counter()
    mvf_cases = [mvf_demo_case(device, noise, closure)
                 for noise, closure in MVF_DEMO_CASES]
    mvf_demo_launches = {"ncc_search": ncc_cuda.LAUNCHES,
                         "symmetric_downdate": covariance.LAUNCHES}
    emit({"phase": "mvf_demo", "phase_s": time.perf_counter() - t0,
          "frames": MVF_DEMO_FRAMES, "cases": mvf_cases,
          "launches": mvf_demo_launches})
    for c in mvf_cases:
        bad = [k for k, v in c["checks"].items() if not v]
        if bad:
            raise AssertionError(f"mvf_demo noise {c['noise_pix']} closure "
                                 f"{c['loop_closure']}: {bad}")
    if any(mvf_demo_launches.values()):
        raise AssertionError(f"mvf_demo: launches {mvf_demo_launches}")

    ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mvf = run_mvf_at_scale(device, torch.float32)
    mvf_free_launches = {"ncc_search": ncc_cuda.LAUNCHES,   # full size alone
                         "symmetric_downdate": covariance.LAUNCHES}
    mvf_keys = ("map_ate_rmse", "traj_ate_rmse", "traj_ate_pre_closure",
                "traj_ate_post_closure", "frames_per_s_integration",
                "frames_per_s_end_to_end")
    from surikatoko_tpu_torch.demos import mvf_at_scale as mas
    bench = {}
    for name, oracle in (("oracle_pairs", True), ("oracle_free", False)):
        t1 = time.perf_counter()
        r = mas.run_at_scale(mas.make_args(**MVF_CLOSURE_CHECK, device=device,
                                           dtype=torch.float32,
                                           oracle_pairs=oracle))
        bench[name] = {**MVF_CLOSURE_CHECK, "s": time.perf_counter() - t1,
                       **{k: r[k] for k in (
                           "traj_ate_pre_closure", "traj_ate_post_closure",
                           "traj_ate_rmse", "map_ate_rmse", "closure_inliers",
                           "closure_pairs_total", "closure_pairs_correct",
                           "place_recognition", "loop_closed",
                           "localization_failures")}}
    mvf_scale_launches = {"ncc_search": ncc_cuda.LAUNCHES,     # all three runs
                          "symmetric_downdate": covariance.LAUNCHES}
    bo, bf = bench["oracle_pairs"], bench["oracle_free"]
    bf_pr = bf["place_recognition"]
    mvf_checks = {
        "finite": all(np.isfinite(mvf[k]) for k in mvf_keys),
        "no_localization_failure": all(
            r["localization_failures"] == 0 for r in (mvf, bo, bf)),
        "loop_closed": all(r["loop_closed"] for r in (mvf, bo, bf)),
        "closure_oracle_free": mvf["closure_oracle_free"],
        "closure_pairs_correct_measured": mvf["closure_pairs_correct"] >= 0,
        "closure_lowers_traj_ate_at_bench_size_oracle":
        bo["traj_ate_post_closure"] < bo["traj_ate_pre_closure"],
        "pr_tracks_at_bench_size": (bf_pr["tracks_revisit"],
                                    bf_pr["tracks_head"]) == PR_BENCH_TRACKS,
        "pr_candidates_at_bench_size": abs(
            bf_pr["candidates"] - PR_BENCH_CANDIDATES)
        <= PR_BENCH_CANDIDATES_SLACK,
        "pr_verified_at_bench_size":
        bf["closure_pairs_total"] >= PR_MIN_VERIFIED
        and bf["closure_pairs_correct"]
        >= PR_MIN_CORRECT_SHARE * bf["closure_pairs_total"],
        "map_ate_within": mvf["map_ate_rmse"] <= MVF_MAP_ATE_BOUND,
        "final_ba_lowers_err": mvf["final_ba"]["err_after"]
        < mvf["final_ba"]["err_before"],
        "no_kernel_launch": not any(mvf_scale_launches.values())}
    emit({"phase": "mvf_at_scale", "phase_s": time.perf_counter() - t0,
          "world": {**MVF_SCALE, "track_len": 12, "noise_pix": 0.5},
          "map_ate_bound": MVF_MAP_ATE_BOUND, **mvf,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "closure_at_bench_size": bench,
          "launches": mvf_scale_launches, "checks": mvf_checks})
    bad = [k for k, v in mvf_checks.items() if not v]
    if bad:
        raise AssertionError(f"mvf_at_scale: {bad}")

    # ---- the two-view toolbox: F, E, pose, correction, calibration ----
    ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
    t0 = time.perf_counter()
    tv_inp = two_view_inputs()
    tv = {}
    for dtype in (torch.float64, torch.float32):
        outs, ms = two_view_run(tv_inp, device, dtype, reps=TWO_VIEW_REPS)
        tv[str(dtype)] = {"host": two_view_host(outs), "ms": ms}
    tv_cpu = two_view_host(two_view_run(tv_inp, "cpu", torch.float64)[0])
    tv_diff = two_view_diff(tv["torch.float64"]["host"], tv_cpu)
    tv_quality = {k: two_view_quality(tv_inp, v["host"]) for k, v in tv.items()}
    two_view_launches = {"ncc_search": ncc_cuda.LAUNCHES,
                         "symmetric_downdate": covariance.LAUNCHES}
    tv_checks = {
        "f64_card_vs_cpu_within_tol": all(
            v == 0 if k.endswith("inliers") else v <= TWO_VIEW_F64_TOL
            for k, v in tv_diff.items()),
        "finite": all(np.isfinite(v).all() for r in tv.values()
                      for v in r["host"].values()),
        "no_kernel_launch": not any(two_view_launches.values())}
    emit({"phase": "two_view", "phase_s": time.perf_counter() - t0,
          "world": TWO_VIEW, "f64_card_vs_cpu_max_abs": tv_diff,
          "tol": TWO_VIEW_F64_TOL,
          **{k: {"quality": tv_quality[k], "step_ms": v["ms"]}
             for k, v in tv.items()},
          "launches": two_view_launches, "checks": tv_checks})
    bad = [k for k, v in tv_checks.items() if not v]
    if bad:
        raise AssertionError(f"two_view: {bad}")

    # ---- batched evaluation: B2's batch axis, the scan runner over noise
    # seeds, batch BA ----
    t0 = time.perf_counter()
    bscan = batch_scan_phase(ncc_cuda, covariance, device)
    ncc_cuda.LAUNCHES = covariance.LAUNCHES = 0
    bba = batch_ba_phase(device)
    bba_launches = {"ncc_search": ncc_cuda.LAUNCHES,
                    "symmetric_downdate": covariance.LAUNCHES}
    batch_checks = {
        **{f"scan_{k}": v for k, v in bscan["checks"].items()},
        **{f"ba_f64_same_decisions_as_alone_B{B}": v for B, v in
           bba["float64"]["same_decisions_as_alone"].items()},
        "ba_finite": all(bba[t][B]["finite"] for t in ("float64", "float32")
                         for B in BATCH_BA_SIZES),
        "ba_no_kernel_launch": not any(bba_launches.values())}
    emit({"phase": "batch_eval", "phase_s": time.perf_counter() - t0,
          "downdate": bdd, "scan": bscan, "ba": bba,
          "ba_launches": bba_launches, "checks": batch_checks})
    bad = [k for k, v in batch_checks.items() if not v]
    if bad:
        raise AssertionError(f"batch_eval: {bad}")
    bdd_main = bdd["timed"]["float32"]
    bdd64_main = bdd["timed"]["float64"]

    # ---- the distribution layer on a one-rank NCCL group ----
    t0 = time.perf_counter()
    shd = sharded_phase(device)
    emit({"phase": "sharded", "phase_s": time.perf_counter() - t0,
          "slab": slab, **shd})
    bad = [k for k, v in shd["checks"].items() if not v]
    if bad:
        raise AssertionError(f"sharded: {bad}")
    sh_launches = shd["imageseq"]["launches"]
    slab_key = "{}x{}x{}_r{}".format(*SLAB_SHAPES[0])
    slab_main = slab["timed"][f"float32_{slab_key}"]
    slab64_main = slab["timed"][f"float64_{slab_key}"]

    dd_main = dd_times["4621x1536"]
    dd64_main = dd64_times["4621x1536"]
    dd_ms = float(np.mean(dd_main["kernel"]))
    emit({"kernels": [{
        "name": "ncc_surface_argmax", "route": "cuda",
        "source": "surikatoko_tpu_torch/csrc/ncc_search.cu",
        "replaces": "surikatoko_tpu/ops/ncc_pallas.py:92",
        "launches": launches["ncc_search"], "max_abs_err": flag_err,
        "launches_by_path": {
            "flagship": launches["ncc_search"],
            "imageseq_hostloop_f32": imseq["float32"]["launches"]["ncc_search"],
            "imageseq_hostloop_f64": imseq["float64"]["launches"]["ncc_search"],
            "imageseq_klt": klt["launches"]["ncc_search"],
            "mvf_demo": mvf_demo_launches["ncc_search"],
            "mvf_at_scale": mvf_scale_launches["ncc_search"],
            "mvf_at_scale_oracle_free": mvf_free_launches["ncc_search"],
            "two_view": two_view_launches["ncc_search"],
            "batch_eval_scan": bscan["launches"]["ncc_search"],
            "batch_eval_ba": bba_launches["ncc_search"],
            "sharded_imageseq": sh_launches["ncc_search"]},
        "imageseq_shapes": {k: {n: v[n] for n in (
            "kernel_ms", "plain_ms", "graph_ms", "kernel_device_us", "bound_ms",
            "bound_by", "pct_of_bound")} for k, v in ncc_imseq.items()},
        "ms": kernel_ms, "plain_ms": plain_ms,
        "graph_ms": ncc_graph_ms["kernel"], "device_us": ncc_device_us,
        "bound_ms": ncc_bound, "bound_by": ncc_bound_by,
        "pct_of_bound": 100.0 * ncc_bound / ncc_graph_ms["kernel"],
        "library_ms": None}, {
        "name": "symmetric_downdate", "route": "cuda",
        "source": "surikatoko_tpu_torch/csrc/symmetric_downdate.cu",
        "replaces": "surikatoko_tpu/ops/covariance.py:53",
        "launches": launches["symmetric_downdate"], "max_abs_err": dd_err,
        "launches_by_path": {
            "flagship": launches["symmetric_downdate"],
            "imageseq_hostloop_f32":
                imseq["float32"]["launches"]["symmetric_downdate"],
            "imageseq_hostloop_f64":
                imseq["float64"]["launches"]["symmetric_downdate"],
            "imageseq_klt": klt["launches"]["symmetric_downdate"],
            "mvf_demo": mvf_demo_launches["symmetric_downdate"],
            "mvf_at_scale": mvf_scale_launches["symmetric_downdate"],
            "mvf_at_scale_oracle_free":
                mvf_free_launches["symmetric_downdate"],
            "two_view": two_view_launches["symmetric_downdate"],
            "batch_eval_scan": bscan["launches"]["symmetric_downdate"],
            "batch_eval_ba": bba_launches["symmetric_downdate"],
            "sharded_imageseq": sh_launches["symmetric_downdate"]},
        "ms": dd_ms, "plain_ms": float(np.mean(dd_main["plain"])),
        "graph_ms": dd_main["graph_ms"]["kernel"],
        "device_us": dd_main["kernel_device_us"],
        "bound_ms": dd_main["bound_ms"], "bound_by": dd_main["bound_by"],
        "pct_of_bound": 100.0 * dd_main["bound_ms"] / dd_ms,
        "library_ms": float(np.mean(dd_main["addmm"])),
        "f64_tile": dd64_main["tile"],
        "f64_launches": pk["float64"]["launches"]["symmetric_downdate"],
        "f64_ms": float(np.mean(dd64_main["kernel"])),
        "f64_graph_ms": dd64_main["graph_ms"]["kernel"],
        "f64_device_us": dd64_main["kernel_device_us"],
        "f64_plain_ms": float(np.mean(dd64_main["plain"])),
        "f64_library_ms": float(np.mean(dd64_main["addmm"])),
        "f64_bound_ms": dd64_main["bound_ms"],
        "f64_bound_by": dd64_main["bound_by"],
        "f64_pct_of_bound": dd64_main["pct_of_bound"],
        "f64_faster_than_library": bool(
            max(dd64_main["kernel"]) < min(dd64_main["addmm"])
            and dd64_main["graph_ms"]["kernel"] < dd64_main["graph_ms"]["addmm"]),
        "f64_max_rel_fro": max(c["rel_fro"] for c in dd64_cases),
        "batched": {
            "entry_points": ["symmetric_downdate_f32_batched",
                             "symmetric_downdate_f64_batched"],
            "launches": bscan["launches"]["symmetric_downdate"],
            "max_err": {t: max(c["err"] for c in bdd["cases"]
                               if c["dtype"] == t)
                        for t in ("float32", "float64")},
            **{t: {"B": v["B"], "D": v["D"], "m": v["m"],
                   "ms": float(np.mean(v["ms"]["batched"])),
                   "graph_ms": v["graph_ms"]["batched"],
                   "device_us": v["device_us"]["batched"],
                   "unbatched_calls_ms": float(np.mean(
                       v["ms"]["unbatched_calls"])),
                   "unbatched_calls_device_us": v["device_us"][
                       "unbatched_calls"],
                   "plain_ms": float(np.mean(v["ms"]["plain"])),
                   "library_ms": float(np.mean(v["ms"]["baddbmm"])),
                   "library_device_us": v["device_us"]["baddbmm"],
                   "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                   "pct_of_bound_device": v["pct_of_bound_device"]}
               for t, v in (("float32", bdd_main), ("float64", bdd64_main))}}}, {
        "name": "symmetric_downdate_rows", "route": "cuda",
        "source": "surikatoko_tpu_torch/csrc/symmetric_downdate.cu",
        "replaces": "surikatoko_tpu/ops/covariance.py:53",
        "slab_of": "surikatoko_tpu/parallel/sharded_ekf.py:210",
        "launches": sh_launches["symmetric_downdate_rows"],
        "max_abs_err": max(c["max_abs_err"] for c in slab["cases"]
                           if c["dtype"] == "float32"),
        "R_D_m_r0": list(SLAB_SHAPES[0]),
        "ms": float(np.mean(slab_main["kernel"])),
        "plain_ms": float(np.mean(slab_main["plain"])),
        "graph_ms": slab_main["graph_ms"]["kernel"],
        "device_us": slab_main["kernel_device_us"],
        "bound_ms": slab_main["bound_ms"], "bound_by": slab_main["bound_by"],
        "pct_of_bound": slab_main["pct_of_bound"],
        "library_ms": float(np.mean(slab_main["addmm"])),
        "f64_ms": float(np.mean(slab64_main["kernel"])),
        "f64_graph_ms": slab64_main["graph_ms"]["kernel"],
        "f64_device_us": slab64_main["kernel_device_us"],
        "f64_plain_ms": float(np.mean(slab64_main["plain"])),
        "f64_library_ms": float(np.mean(slab64_main["addmm"])),
        "f64_bound_ms": slab64_main["bound_ms"],
        "f64_bound_by": slab64_main["bound_by"],
        "f64_pct_of_bound": slab64_main["pct_of_bound"],
        "bitwise_full_b2": all(c["bitwise_full"] for c in slab["cases"]),
        "shapes": {k: slab_report(v) for k, v in slab["timed"].items()}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
