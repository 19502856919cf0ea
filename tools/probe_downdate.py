#!/usr/bin/env python3
"""Probe of the symmetric downdate kernel (csrc/symmetric_downdate.cu) on one
CUDA card: ptxas's report, bitwise checks and timing sweeps over the float32
forms, the data behind the rules of ``ops/covariance.py``.

    python3 tools/probe_downdate.py [--ref-source FILE] [--flagship-frames N]
                                    [--clock-seconds S] [--no-sweep] [--slabs]
                                    [--small] [--timeline] [--out FILE]

* every shape of ``chip_smoke.DOWNDATE_SHAPES``, without and with keep, is
  held to ``chip_smoke.compare_downdate`` (the plain version's tolerance,
  bitwise symmetric, two launches bitwise equal), and each float32 form of
  ``covariance.F32_FORMS`` must give the wrapper's bits.
* ``--ref-source``: another version of the kernel source, with the earlier C
  entry point ``symmetric_downdate_f32(P, M, keep, out, D, m, stream)`` or
  the current one (scratch and form, an earlier build's form being its tile
  edge, 32 or 128, by PR 4's rule: ``covariance.slab_tile``); it is built
  beside the current one, compared bit for bit on the shapes above and
  timed in turns (ref, new, new, ref) at the main-path shapes.
* float64: every shape of ``chip_smoke.DOWNDATE_SHAPES`` in float64 held to
  ``chip_smoke.compare_downdate_f64`` (bitwise symmetric, two launches
  bitwise equal, relative Frobenius difference to the plain version
  <= 1e-12); its device time at the main-path shapes. With
  ``--ref-source``, the reference build's float64 entry point
  ``symmetric_downdate_f64(P, M, keep, out, D, m, stream)`` too, held to the
  same bound and timed in turns with the new (events, graph replay, device
  time).
* the SASS opcode counts of each kernel (DMMA on the FP64 tensor cores,
  DFMA and FFMA on the vector lanes), from cuobjdump.
* ``--flagship-frames N`` runs the K=768 flagship loop for N frames and
  checks the kernel (and the reference build) on that state's (P, B, keep).
* ``--clock-seconds S`` runs the kernel back to back at the flagship shape
  for about S seconds while nvidia-smi samples the SM clock and power.
* the sweep times each float32 form at D = 13 + 6K, m = 2K for K from 16 to
  768 with a 0/1 keep (CUDA events and the profiler's device time), and the
  float64 entry point there by device time (and the reference build's with
  ``--ref-source``).
* ``--slabs``: the row-slab forms at (R, r0) of SLAB_SWEEP, D = 4621, m =
  1536 (K = 768) with a 0/1 keep, float32 and float64: the thin kernel at
  each column width of THIN_CWS (float64 has no 48; up to
  THIN_SWEEP_MAX_R rows), the tiled
  form with and without the split of its last wave, and with
  ``--ref-source`` that build's row-slab entry point (its own tile), each
  held bit for bit to the full call's rows and timed in turns by graph
  replay and device time, beside a masked addmm of the rows and the
  wrapper's pick (``rows_config``): the data behind ``rows_config``'s rule.
  ``--no-sweep`` skips the D sweep, not this one.
* ``--small``: B problems of [D,D] (B in SMALL_B, D in SMALL_D, m in
  SMALL_M), each with its own P, M and keep, through every float32 form of
  the batched entry point, the wrapper and, with ``--ref-source``, that
  build's at PR 4's tile, each held bit for bit to the others and timed by
  CUDA-graph replay, the reference build before and after the forms (and
  the reference and the wrapper by the profiler's device time): the data
  behind ``covariance.f32_form``'s rule (``small_sweep``).
* ``--timeline``: where a block's time goes, form by form: an instrumented
  copy of the source records each block's phases (``timeline``).
One JSON line per result on stdout, and also in ``--out`` FILE if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# the single-problem C entry points, the interface that earlier builds
# share: f32 (P, M, keep, Mp, out, D, m, form, stream; an earlier build's
# form is its tile edge, 32 or 128), f64 (P, M, keep, out, D, m, stream)
F32_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
F64_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
SWEEP_K = (16, 32, 48, 64, 96, 128, 160, 192, 224, 256, 320, 384, 512, 768)
# the row slabs (R, r0) at K = 768: the camera rows and their neighbours,
# the thin form's reach, one rank of 8, 4, 2 (both ranks) and 1
SLAB_D, SLAB_M = 4621, 1536
SLAB_SWEEP = ((13, 0), (16, 0), (17, 0), (32, 13), (64, 13), (128, 13),
              (256, 13), (576, 13 + 576), (1152, 13 + 1152), (2304, 13),
              (2304, 13 + 2304), (4608, 13))
THIN_CWS = (16, 32, 48, 64)
# the --small sweep: B problems of [D,D], m rows of M (D = 13 + 6K for K =
# 5, 16, 48, 96, 164, 320, 384: the tests' shapes, scenario03's, and both
# sides of PR 4's tile threshold)
SMALL_B = (1, 4, 32, 128)
SMALL_D = (43, 109, 301, 589, 1000, 1933, 2317)
SMALL_M = (32, 96, 192)
THIN_SWEEP_MAX_R = 256


def run_f32(fn, P, M, keep, form, padded):
    """One call of a build's current f32 entry point (scratch and form),
    returning its output."""
    import torch
    D, m = P.shape[0], M.shape[0]
    out = torch.empty_like(P)
    scratch = (torch.empty((m, -(-D // 4) * 4), device=P.device)
               if padded else None)
    rc = fn(P.data_ptr(), M.data_ptr(), None if keep is None else keep.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            D, m, form, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"form {form}: CUDA error {rc}")
    return out


def launcher(cov, form):
    """The wrapper's kernel in a forced form (an index of F32_FORMS)."""
    from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
    fn = KernelLibrary(cov._LIB.source.name, "symmetric_downdate_f32",
                       F32_ARGS).fn()
    padded = cov.F32_FORMS[form].padded
    return lambda P, M, keep: run_f32(fn, P, M, keep, form, padded)


def batched_launcher(fn, form, padded):
    """A build's batched f32 entry point (P, M, keep, Mp, out, B, D, m, form,
    sP, sM, sK, stream) on P [B,D,D], M [B,m,D], keep [B,D] in one form (an
    earlier build's: its tile edge)."""
    import torch

    def run(P, M, keep):
        B, D, m = P.shape[0], P.shape[-1], M.shape[-2]
        out = torch.empty_like(P)
        scratch = (torch.empty((B, m, -(-D // 4) * 4), device=P.device)
                   if padded else None)
        rc = fn(P.data_ptr(), M.data_ptr(), keep.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                out.data_ptr(), B, D, m, form, D * D, m * D, D,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"form {form}: CUDA error {rc}")
        return out
    return run


def ref_launcher(path: str):
    """Builds of another kernel source: (f32 run, f64 run or None, its
    library). The f32 entry point takes the scratch and the tile edge (the
    current one) if the source names ``Mp``, else the earlier (P, M, keep,
    out, D, m, stream); the f64 one is (P, M, keep, out, D, m, stream), and
    a source without ``symmetric_downdate_f64`` gives no f64 run."""
    import torch
    from surikatoko_tpu_torch.ops import covariance as cov
    from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
    text = Path(path).read_text()
    early = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    current = "float* Mp" in text
    lib = KernelLibrary(str(Path(path).resolve()), "symmetric_downdate_f32",
                        F32_ARGS if current else early)
    fn = lib.fn()

    def run(P, M, keep):
        if current:
            tile = cov.slab_tile(P.shape[0])
            return run_f32(fn, P, M, keep, tile, tile == 128)
        out = torch.empty_like(P)
        rc = fn(P.data_ptr(), M.data_ptr(), None if keep is None else keep.data_ptr(),
                out.data_ptr(), P.shape[0], M.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"reference kernel: CUDA error {rc}")
        return out

    run64 = None
    if "symmetric_downdate_f64" in text:
        fn64 = KernelLibrary(str(Path(path).resolve()), "symmetric_downdate_f64",
                             F64_ARGS).fn()

        def run64(P, M, keep):
            out = torch.empty_like(P)
            rc = fn64(P.data_ptr(), M.data_ptr(),
                      None if keep is None else keep.data_ptr(), out.data_ptr(),
                      P.shape[0], M.shape[0], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"reference f64 kernel: CUDA error {rc}")
            return out
    return run, run64, lib


def slab_forms(cov, ref_lib, sms):
    """{name: fn(Pr, M, keep, r0) -> out} of the row-slab forms, float32 or
    float64 by the arguments' type, each launching its entry point
    directly: thin_<cw>; tiles, the full call's edge (float32 128, its
    grid from the slab's first row; float64 the DMMA kernel's 64);
    tiles_split, the float32 grid with rows_config's split of its last
    wave; and with ``ref_lib`` (another build's path) ref, that build's
    symmetric_downdate_rows_f32 (P_rows, M, keep, Mp, out, D, m, r0, R,
    tile, stream) / _f64 at its own tile."""
    import torch
    from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary

    def call(fn, *args):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"slab form: CUDA error {rc}")

    def thin(cw):
        def run(Pr, M, keep, r0):
            out = torch.empty_like(Pr)
            lib = cov._LIB_THIN64 if Pr.dtype == torch.float64 else cov._LIB_THIN
            call(lib.fn(), Pr.data_ptr(), M.data_ptr(),
                 None if keep is None else keep.data_ptr(), out.data_ptr(),
                 M.shape[1], M.shape[0], r0, Pr.shape[0], cw)
            return out
        return run

    def tiles(f32_fn, f64_fn, edge, split=None):
        def run(Pr, M, keep, r0):
            out = torch.empty_like(Pr)
            D, m, kp = M.shape[1], M.shape[0], None if keep is None else keep.data_ptr()
            if Pr.dtype == torch.float64:
                call(f64_fn, Pr.data_ptr(), M.data_ptr(), kp, out.data_ptr(),
                     D, m, r0, Pr.shape[0])
                return out
            e = edge or cov.slab_tile(D)
            # room for a grid origin of up to 127 zero columns
            scratch = (torch.empty((m, -(-(D + 127) // 4) * 4),
                                   device=M.device) if e == 128 else None)
            args = [Pr.data_ptr(), M.data_ptr(), kp,
                    None if scratch is None else scratch.data_ptr(),
                    out.data_ptr(), D, m, r0, Pr.shape[0], e]
            if split is not None:
                args.append(cov.rows_config(D, Pr.shape[0], r0, Pr.dtype,
                                            sms)[3] if split else 0)
            call(f32_fn, *args)
            return out
        return run

    rows, rows64 = cov._LIB_ROWS.fn(), cov._LIB_ROWS64.fn()
    forms = {f"thin_{cw}": thin(cw) for cw in THIN_CWS}
    forms["tiles"] = tiles(rows, rows64, 128, False)
    forms["tiles_split"] = tiles(rows, rows64, 128, True)
    if ref_lib:
        f32 = KernelLibrary(ref_lib, "symmetric_downdate_rows_f32",
                            cov._LIB_ROWS.argtypes[:-2]
                            + cov._LIB_ROWS.argtypes[-1:]).fn()
        f64 = KernelLibrary(ref_lib, "symmetric_downdate_rows_f64",
                            cov._LIB_ROWS64.argtypes).fn()
        forms["ref"] = tiles(f32, f64, None)
    return forms


def device_us(fn):
    """chip_smoke.device_us_per_call, or None where the profiler recorded
    no device event (not measured)."""
    try:
        return cs.device_us_per_call(fn)
    except RuntimeError:
        return None


def slab_sweep(cov, dev, ref_source, emit) -> bool:
    """The ``--slabs`` sweep; True if every form equals the full call's
    rows bit for bit and repeats."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = slab_forms(cov, str(Path(ref_source).resolve()) if ref_source
                       else None, sms)
    # f32 lanes and FP64 tensor-core FMAs per SM and clock are both 128
    fma_per_s = sms * cs.F32_LANES_PER_SM * float(
        cs.nvidia_smi("clocks.max.sm", units=False)) * 1e6
    ok = True
    for dtype in (torch.float32, torch.float64):
        P, M, keep = cs.downdate_case(SLAB_D, SLAB_M, True, dev, dtype)
        full = cov.symmetric_downdate(P, M, keep)
        Mk = M * keep[None, :]
        for R, r0 in SLAB_SWEEP:
            Pr = P[r0:r0 + R].contiguous()
            want = full[r0:r0 + R]
            fns = {}
            for name, f in forms.items():
                if name.startswith("thin") and (
                        R > THIN_SWEEP_MAX_R
                        or (dtype == torch.float64 and name == "thin_48")):
                    continue
                if name == "tiles_split" and not cov.rows_config(
                        SLAB_D, R, r0, dtype, sms)[3]:
                    continue
                fns[name] = (lambda f=f: f(Pr, M, keep, r0))
            fns["wrapper"] = lambda: cov.symmetric_downdate_rows(Pr, M, keep, r0)
            fns["addmm"] = lambda: torch.addmm(
                Pr * (keep[r0:r0 + R, None] * keep[None, :]),
                Mk[:, r0:r0 + R].T, Mk, alpha=-1)
            bitwise = {}
            for name, f in fns.items():
                if name == "addmm":
                    continue
                got = f()
                bitwise[name] = bool(torch.equal(got, want) and torch.equal(got, f()))
            fma, vals = cs.slab_work(R, SLAB_D, SLAB_M)
            b_ms, b_by = cs.bound_ms(fma, vals * P.element_size(), fma_per_s)
            reps = max(5, min(200, int(2e4 / (1 + fma / 1e7))))
            order = list(fns) + list(reversed(fns))
            graph = {k: [] for k in fns}
            for name in order:
                graph[name].append(cs.cuda_graph_ms(fns[name], reps))
            dev_us = {k: device_us(f) for k, f in fns.items()}
            row = {"probe": "slab", "dtype": str(dtype).split(".")[-1], "R": R,
                   "r0": r0, "D": SLAB_D, "m": SLAB_M,
                   "pick": list(cov.rows_config(SLAB_D, R, r0, dtype, sms)),
                   "bitwise_full": bitwise, "graph_ms": graph,
                   "device_us": dev_us, "bound_ms": b_ms, "bound_by": b_by,
                   "grid_tiles": cov.tile_grid(
                       SLAB_D, R, r0, cov.slab_tile(SLAB_D, dtype))}
            emit(row)
            ok &= all(bitwise.values())
    return ok


def small_sweep(cov, dev, ref_source, emit) -> bool:
    """The ``--small`` sweep: B problems of [D,D] for B in SMALL_B, D in
    SMALL_D, m in SMALL_M, each with its own P, M and 0/1 keep
    (chip_smoke.batch_downdate_case), through every float32 form of the
    batched entry point, the wrapper and, with ``ref_source``, that build's
    batched entry point at its own tile (PR 4's rule, covariance.slab_tile).
    Each is held bit for bit
    to the first form's output (and to the reference build's) and timed by
    CUDA-graph replay (pad_rows included), the reference build before and
    after the forms; the reference build and the wrapper also by the
    profiler's device time (`pad_us`: pad_rows' share); the data behind
    ``downdate_config``'s rule. True if every output is bit for bit."""
    import torch
    from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
    lib = cov._LIB.fn()
    forms = {form.name: batched_launcher(lib, f, form.padded)
             for f, form in enumerate(cov.F32_FORMS)}
    ref = None
    if ref_source:
        fn = KernelLibrary(str(Path(ref_source).resolve()),
                           "symmetric_downdate_f32_batched",
                           cov._LIB.argtypes).fn()
        ref = lambda P, M, keep: batched_launcher(
            fn, cov.slab_tile(P.shape[-1]),
            cov.slab_tile(P.shape[-1]) == 128)(P, M, keep)
    fma_per_s = (torch.cuda.get_device_properties(dev).multi_processor_count
                 * cs.F32_LANES_PER_SM
                 * float(cs.nvidia_smi("clocks.max.sm", units=False)) * 1e6)
    ok = True
    for m in SMALL_M:
        for D in SMALL_D:
            for B in SMALL_B:
                P, M, keep = cs.batch_downdate_case(B, D, m, dev, torch.float32)
                fns = {}
                if ref is not None:
                    fns["ref"] = lambda: ref(P, M, keep)
                fns.update({k: (lambda f=f: f(P, M, keep))
                            for k, f in forms.items()})
                if B == 1:
                    fns["wrapper"] = lambda: cov.symmetric_downdate(
                        P[0], M[0], keep[0])[None]
                else:
                    fns["wrapper"] = lambda: cov.symmetric_downdate(P, M, keep)
                want = fns[cov.F32_FORMS[0].name]()
                bitwise = {}
                for name, f in fns.items():
                    got = f()
                    torch.cuda.synchronize()
                    bitwise[name] = bool(torch.equal(got, want))
                del got
                # device time a call by CUDA-graph replay, the reference
                # build first and last; the profiler's device time (and
                # pad_rows' share) for the reference and the wrapper
                reps = max(3, min(100, int(3e3 / (1 + B * D * D * m / 2e7))))
                order = list(fns) + (["ref"] if ref is not None else [])
                graph_us = {}
                for name in order:
                    graph_us.setdefault(name, []).append(
                        1e3 * cs.cuda_graph_ms(fns[name], reps))
                dev_us, pad_us = {}, {}
                for name in ("ref", "wrapper"):
                    if name not in fns:
                        continue
                    try:
                        prof = cs.profiled(
                            lambda: [fns[name]() for _ in range(5)])
                    except RuntimeError:
                        dev_us[name] = None    # not measured
                        continue
                    dev_us[name] = prof[0] / 5
                    pad_us[name] = sum(v[0] for k, v in prof[3].items()
                                       if "pad_rows" in k) / 5
                fma, nbytes = cs.downdate_work(D, m, True)
                b_ms, b_by = cs.bound_ms(B * fma, B * nbytes, fma_per_s)
                timed = {k: min(v) for k, v in graph_us.items()
                         if k in forms}
                best = min(timed, key=timed.get)
                row = {"probe": "small", "B": B, "D": D, "m": m,
                       "pick": cov.F32_FORMS[cov.f32_form(D, B)].name,
                       "bitwise": bitwise, "graph_us": graph_us,
                       "reps": reps, "device_us": dev_us,
                       "pad_us": {k: v for k, v in pad_us.items() if v},
                       "best": best, "best_us": timed[best],
                       "bound_ms": b_ms, "bound_by": b_by}
                emit(row)
                ok &= all(bitwise.values())
                del P, M, keep
    return ok


# --timeline: the forms and shapes timed block by block
TIMELINE_FORMS = ("Tile32", "Batch32", "Small32")
TIMELINE_SHAPES = ((32, 589, 192), (1, 589, 192))
# text of csrc/symmetric_downdate.cu and what the instrumented copy puts in
# its place: globaltimer at a block's start, after its first panel landed,
# after its k-loop and at its end, and its SM, into a device array
_TIMELINE_EDITS = (
    ("""  constexpr int TILE = C::TILE, KP = C::KP, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
""", """  constexpr int TILE = C::TILE, KP = C::KP, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const long long t_start = gtimer();
  long long t_first = 0;
"""),
    ("""      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (panel + STAGES - 1 < n_panels) load_panel(panel + STAGES - 1);
      cp_async_commit();
      if (!busy) continue;""", """      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (panel == 0) t_first = gtimer();
      if (panel + STAGES - 1 < n_panels) load_panel(panel + STAGES - 1);
      cp_async_commit();
      if (!busy) continue;"""),
    ("""  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it becomes the epilogue tile

  float* tile = smem;   // [TILE][TILE + 1]""", """  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it becomes the epilogue tile
  const long long t_kloop = gtimer();

  float* tile = smem;   // [TILE][TILE + 1]"""),
    ("""    write_tile<TILE, C::THREADS, HAS_KEEP, float, C::EPI>(
        tile, P, keep, out, D, i0, j0, bi == bj, tid);
}""", """    write_tile<TILE, C::THREADS, HAS_KEEP, float, C::EPI>(
        tile, P, keep, out, D, i0, j0, bi == bj, tid);
  __syncthreads();
  const long long x = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0 && MODE != ROWS && x < DBG_N) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    dbg[x * 5 + 0] = t_start;
    dbg[x * 5 + 1] = t_first;
    dbg[x * 5 + 2] = t_kloop;
    dbg[x * 5 + 3] = gtimer();
    dbg[x * 5 + 4] = sm;
  }
}"""),
    ("""namespace {
""", """namespace {
constexpr long long DBG_N = 1 << 16;
__device__ long long dbg[DBG_N * 5];
__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""),
)
_TIMELINE_TAIL = """
extern "C" int timeline_copy(long long* dst, long long n) {
  return (int)cudaMemcpyFromSymbol(dst, dbg, n * 5 * sizeof(long long));
}
"""


def timeline(cov, dev, emit) -> bool:
    """The ``--timeline`` probe: an instrumented copy of the kernel source
    (in the build directory) records each block's start, the landing of its
    first panel, the end of its k-loop and its end (globaltimer) and its SM;
    for each form of TIMELINE_FORMS at each shape of TIMELINE_SHAPES (B
    problems of chip_smoke.batch_downdate_case), one call after five warm
    ones: the median of each phase over the blocks, the blocks an SM and
    how many run at once. True if every call matched the product build's
    output bit for bit."""
    import numpy as np
    import torch
    from surikatoko_tpu_torch.ops.cuda_build import BUILD_DIR, KernelLibrary
    src = cov._LIB.source.read_text()
    for old, new in _TIMELINE_EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"timeline: the kernel source changed near "
                               f"{old.strip().splitlines()[0]!r}")
        src = src.replace(old, new)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "symmetric_downdate_timeline.cu"
    path.write_text(src + _TIMELINE_TAIL)
    lib = KernelLibrary(str(path), "symmetric_downdate_f32_batched",
                        cov._LIB.argtypes)
    fn = lib.fn()
    copy = ctypes.CDLL(str(lib.path())).timeline_copy
    copy.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    product = cov._LIB.fn()
    names = [f.name for f in cov.F32_FORMS]
    ok = True
    for B, D, m in TIMELINE_SHAPES:
        P, M, keep = cs.batch_downdate_case(B, D, m, dev, torch.float32)
        for name in TIMELINE_FORMS:
            form = names.index(name)
            padded = cov.F32_FORMS[form].padded
            run = batched_launcher(fn, form, padded)
            for _ in range(5):
                got = run(P, M, keep)
            n = B * cov._tiles(D, cov.F32_FORMS[form].tile)
            buf = (ctypes.c_longlong * (5 * n))()
            got = run(P, M, keep)
            torch.cuda.synchronize()
            if copy(ctypes.addressof(buf), n) != 0:
                raise RuntimeError("timeline: copy failed")
            same = bool(torch.equal(got, batched_launcher(
                product, form, padded)(P, M, keep)))
            a = np.array(buf, dtype=np.int64).reshape(n, 5)
            t0 = a[:, 0].min()
            start, end = (a[:, 0] - t0) / 1e3, (a[:, 3] - t0) / 1e3
            at = np.linspace(0.0, end.max(), 41)[5:-5]
            emit({"probe": "timeline", "form": name, "B": B, "D": D, "m": m,
                  "blocks": n, "span_us": float(end.max()),
                  "first_panel_us": float(np.median((a[:, 1] - a[:, 0]) / 1e3)),
                  "k_loop_us": float(np.median((a[:, 2] - a[:, 1]) / 1e3)),
                  "epilogue_us": float(np.median((a[:, 3] - a[:, 2]) / 1e3)),
                  "block_us": float(np.median((a[:, 3] - a[:, 0]) / 1e3)),
                  "blocks_per_sm_max": int(np.bincount(a[:, 4]).max()),
                  "blocks_at_once_median": float(np.median(
                      [((start <= t) & (end > t)).sum() for t in at])),
                  "bitwise_product": same})
            ok &= same
    return ok


def sass_ops(lib_path, ops=("DMMA", "DFMA", "FFMA", "LDGSTS")) -> dict:
    """{kernel: {opcode: count}} of the library's SASS (cuobjdump), for the
    kernels that contain any of ``ops``: which run on the FP64 tensor
    cores (DMMA) and which on the vector lanes (DFMA, FFMA), and their
    cp.async copies (LDGSTS)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
        elif name:
            for op in ops:
                if f" {op}" in ln:
                    c = counts.setdefault(name, {})
                    c[op] = c.get(op, 0) + 1
    return counts


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-source")
    ap.add_argument("--flagship-frames", type=int, default=0)
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--slabs", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--clock-seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_downdate: no CUDA device", file=sys.stderr)
        return 1
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.ops import covariance as cov
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    config.set_full_precision()
    sink = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        sink = open(args.out, "w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    cov.build()
    emit({"probe": "env", "nvidia_smi": cs.nvidia_smi("name,power.limit"),
          "clocks_max_sm": cs.nvidia_smi("clocks.max.sm"),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": cs.ptxas_summary(cov._LIB),
          "sass_ops": sass_ops(cov._LIB.build())})
    kern = {form.name: launcher(cov, f) for f, form in enumerate(cov.F32_FORMS)}
    ref = ref64 = None
    if args.ref_source:
        ref, ref64, ref_lib = ref_launcher(args.ref_source)
        emit({"probe": "ref_build", "source": args.ref_source,
              "ptxas": cs.ptxas_summary(ref_lib)})

    def check(name, P, M, keep):
        err, ok = cs.compare_downdate(cov, P, M, keep)
        got = cov.symmetric_downdate(P, M, keep)
        row = {"probe": "check", "case": name, "D": P.shape[0], "m": M.shape[0],
               "keep": keep is not None,
               "form": cov.F32_FORMS[cov.f32_form(P.shape[0])].name,
               "max_abs_err": err, "ok": ok,
               "forms_bitwise": {f: bool(torch.equal(k(P, M, keep), got))
                                 for f, k in kern.items()}}
        if ref is not None:
            r = ref(P, M, keep)
            row["ref_bitwise"] = bool(torch.equal(r, got))
            row["ref_max_abs_diff"] = float((r - got).abs().max())
        emit(row)
        return (ok and all(row["forms_bitwise"].values())
                and row.get("ref_bitwise", True))

    ok = True
    for D, m in cs.DOWNDATE_SHAPES:
        for with_keep in (False, True):
            ok &= check("random", *cs.downdate_case(D, m, with_keep, dev))

    def rel_fro(got, want):
        return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))

    def f64_ok(got, again, want):
        return (torch.equal(got, got.T) and torch.equal(got, again)
                and bool(torch.isfinite(got).all())
                and rel_fro(got, want) <= cs.F64_REL_FRO)

    for D, m in cs.DOWNDATE_SHAPES:
        for with_keep in (False, True):
            P, M, keep = cs.downdate_case(D, m, with_keep, dev, torch.float64)
            rel, ok64 = cs.compare_downdate_f64(cov, P, M, keep)
            row = {"probe": "check_f64", "D": D, "m": m, "keep": with_keep,
                   "rel_fro": rel}
            if ref64 is not None:
                want = cov.symmetric_downdate_ref(P, M, keep)
                got = ref64(P, M, keep)
                row["ref_rel_fro"] = rel_fro(got, want)
                ok64 &= f64_ok(got, ref64(P, M, keep), want)
            row["ok"] = ok64
            emit(row)
            ok &= ok64

    if args.flagship_frames > 0:
        from surikatoko_tpu_torch.models.monoslam import init_state
        from surikatoko_tpu_torch.world.device_runner import (
            init_imageseq, make_imageseq_scan_runner)
        params, sc = cs.flagship_setup(dev)
        st, tm = init_imageseq(params, sc, init_state(
            cs.K_FLAGSHIP, dtype=sc.background.dtype, device=dev), 15)
        run = make_imageseq_scan_runner(params, templ_width=15, recruit=True,
                                        recruit_max=12, detector_corners=64,
                                        recruit_depth="local")
        st = run(st, tm, sc, range(1, 1 + args.flagship_frames))[0]
        ok &= check(f"flagship_frame_{1 + args.flagship_frames}",
                    *cs.flagship_downdate_inputs(params, st))
        del params, sc, st, tm

    for D, m in cs.DOWNDATE_TIMED:
        P, M, keep = cs.downdate_case(D, m, True, dev)
        new = lambda: cov.symmetric_downdate(P, M, keep)
        row = {"probe": "device_us", "D": D, "m": m,
               "kernel": cs.device_us_per_call(new)}
        if ref is not None:
            old = lambda: ref(P, M, keep)
            n = 200 if D < 1000 else 40
            tm = {"ref": [], "new": []}
            for name, f in (("ref", old), ("new", new), ("new", new), ("ref", old)):
                tm[name].append(cs.cuda_ms(f, n))
            row.update(ref=cs.device_us_per_call(old), ref_vs_new_ms=tm)
        P, M, keep = cs.downdate_case(D, m, True, dev, torch.float64)
        new = lambda: cov.symmetric_downdate(P, M, keep)
        row["kernel_f64"] = cs.device_us_per_call(new)
        if ref64 is not None:
            old = lambda: ref64(P, M, keep)
            n = 200 if D < 1000 else 20
            tm = {"ref": [], "new": []}
            us = {"ref": [], "new": []}
            for name, f in (("ref", old), ("new", new), ("new", new), ("ref", old)):
                tm[name].append(cs.cuda_ms(f, n))
                us[name].append(cs.device_us_per_call(f))
            row.update(ref_f64_vs_new_ms=tm, ref_f64_vs_new_device_us=us,
                       ref_f64_vs_new_graph_ms={
                           name: cs.cuda_graph_ms(f, max(n // 4, 5))
                           for name, f in (("ref", old), ("new", new))})
        emit(row)

    if args.clock_seconds > 0:
        # SM clock and power while the kernel runs back to back at the
        # flagship shape: the clock the FMA rate really had
        P, M, keep = cs.downdate_case(4621, 1536, True, dev)
        mon = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        n = int(args.clock_seconds / 1.1e-3)
        ms = cs.cuda_ms(lambda: cov.symmetric_downdate(P, M, keep), n)
        mon.terminate()
        rows = [[float(x) for x in ln.split(",")]
                for ln in mon.communicate(timeout=30)[0].splitlines() if ln.strip()]
        rows = rows[len(rows) // 4:]   # past the ramp
        emit({"probe": "clock_under_load", "D": 4621, "m": 1536, "launches": n,
              "ms": ms, "samples": len(rows),
              "clocks_sm_mhz": sorted(r[0] for r in rows)[len(rows) // 2] if rows else None,
              "power_w": sorted(r[1] for r in rows)[len(rows) // 2] if rows else None,
              "temperature_c": max(r[2] for r in rows) if rows else None})

    if args.slabs:
        ok &= slab_sweep(cov, dev, args.ref_source, emit)

    if args.small:
        ok &= small_sweep(cov, dev, args.ref_source, emit)

    if args.timeline:
        ok &= timeline(cov, dev, emit)

    if not args.no_sweep:
        for K in SWEEP_K:
            D, m = 13 + 6 * K, 2 * K
            P, M, keep = cs.downdate_case(D, m, True, dev)
            n = max(20, min(400, int(4e5 / D ** 1.5)))
            times = {f: cs.cuda_ms(lambda: k(P, M, keep), n)
                     for f, k in kern.items()}
            dev_us = {f: cs.device_us_per_call(lambda: k(P, M, keep))
                      for f, k in kern.items()}
            fma = D * (D + 1) / 2 * m
            emit({"probe": "sweep", "K": K, "D": D, "m": m, "reps": n,
                  "ms": times, "device_us": dev_us,
                  "pick": cov.F32_FORMS[cov.f32_form(D)].name,
                  "best_device": min(dev_us, key=dev_us.get),
                  "tfma_per_s_device": {t: fma / (v * 1e-6) / 1e12
                                        for t, v in dev_us.items()}})
            # float64: the wrapper's DMMA kernel, and the reference build's
            P, M, keep = cs.downdate_case(D, m, True, dev, torch.float64)
            fns = {"new": lambda: cov.symmetric_downdate(P, M, keep)}
            if ref64 is not None:
                fns["ref"] = lambda: ref64(P, M, keep)
            dev_us = {k: cs.device_us_per_call(f) for k, f in fns.items()}
            emit({"probe": "sweep_f64", "K": K, "D": D, "m": m,
                  "device_us": dev_us,
                  "tfma_per_s_device": {k: fma / (v * 1e-6) / 1e12
                                        for k, v in dev_us.items()}})
    if sink:
        sink.close()
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
