#!/usr/bin/env python3
"""Probe of the symmetric downdate kernel (csrc/symmetric_downdate.cu) on one
CUDA card: ptxas's report, bitwise checks and a timing sweep over the tile
edges, the data behind the tile threshold of ``ops/covariance.py``.

    python3 tools/probe_downdate.py [--ref-source FILE] [--flagship-frames N]
                                    [--clock-seconds S] [--no-sweep] [--out FILE]

* every shape of ``chip_smoke.DOWNDATE_SHAPES``, without and with keep, is
  held to ``chip_smoke.compare_downdate`` (the plain version's tolerance,
  bitwise symmetric, two launches bitwise equal), and each tile edge (32,
  128) must give the wrapper's bits.
* ``--ref-source``: another version of the kernel source, with the earlier C
  entry point ``symmetric_downdate_f32(P, M, keep, out, D, m, stream)`` or
  the current one (scratch and tile edge too); it is built beside the
  current one, compared bit for bit on the shapes above and timed in turns
  (ref, new, new, ref) at the main-path shapes.
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
* the sweep times each tile edge at D = 13 + 6K, m = 2K for K from 16 to 768
  with a 0/1 keep (CUDA events and the profiler's device time), and the
  float64 entry point there by device time (and the reference build's with
  ``--ref-source``).
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

TILES = (32, 128)
# the single-problem C entry points, the interface that earlier builds
# share: f32 (P, M, keep, Mp, out, D, m, tile, stream), f64 (P, M, keep,
# out, D, m, stream)
F32_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
F64_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
SWEEP_K = (16, 32, 48, 64, 96, 128, 160, 192, 224, 256, 320, 384, 512, 768)


def run_f32(fn, P, M, keep, tile):
    """One call of a build's current f32 entry point (scratch and tile
    edge), returning its output."""
    import torch
    D, m = P.shape[0], M.shape[0]
    out = torch.empty_like(P)
    scratch = (torch.empty((m, -(-D // 4) * 4), device=P.device)
               if tile == 128 else None)
    rc = fn(P.data_ptr(), M.data_ptr(), None if keep is None else keep.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            D, m, tile, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile {tile}: CUDA error {rc}")
    return out


def launcher(cov, tile):
    """The wrapper's kernel with a forced tile edge."""
    from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
    fn = KernelLibrary(cov._LIB.source.name, "symmetric_downdate_f32",
                       F32_ARGS).fn()
    return lambda P, M, keep: run_f32(fn, P, M, keep, tile)


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
            return run_f32(fn, P, M, keep, cov.downdate_config(P.shape[0])[0])
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


def sass_ops(lib_path, ops=("DMMA", "DFMA", "FFMA")) -> dict:
    """{kernel: {opcode: count}} of the library's SASS (cuobjdump), for the
    kernels that contain any of ``ops``: which run on the FP64 tensor
    cores (DMMA) and which on the vector lanes (DFMA, FFMA)."""
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
    kern = {t: launcher(cov, t) for t in TILES}
    ref = ref64 = None
    if args.ref_source:
        ref, ref64, ref_lib = ref_launcher(args.ref_source)
        emit({"probe": "ref_build", "source": args.ref_source,
              "ptxas": cs.ptxas_summary(ref_lib)})

    def check(name, P, M, keep):
        err, ok = cs.compare_downdate(cov, P, M, keep)
        got = cov.symmetric_downdate(P, M, keep)
        row = {"probe": "check", "case": name, "D": P.shape[0], "m": M.shape[0],
               "keep": keep is not None, "tile": cov.downdate_config(P.shape[0])[0],
               "max_abs_err": err, "ok": ok,
               "tiles_bitwise": {t: bool(torch.equal(kern[t](P, M, keep), got))
                                 for t in TILES}}
        if ref is not None:
            r = ref(P, M, keep)
            row["ref_bitwise"] = bool(torch.equal(r, got))
            row["ref_max_abs_diff"] = float((r - got).abs().max())
        emit(row)
        return (ok and all(row["tiles_bitwise"].values())
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

    if not args.no_sweep:
        for K in SWEEP_K:
            D, m = 13 + 6 * K, 2 * K
            P, M, keep = cs.downdate_case(D, m, True, dev)
            n = max(20, min(400, int(4e5 / D ** 1.5)))
            times = {t: cs.cuda_ms(lambda: kern[t](P, M, keep), n) for t in TILES}
            dev_us = {t: cs.device_us_per_call(lambda: kern[t](P, M, keep))
                      for t in TILES}
            fma = D * (D + 1) / 2 * m
            emit({"probe": "sweep", "K": K, "D": D, "m": m, "reps": n,
                  "ms": times, "device_us": dev_us, "pick": cov.downdate_config(D)[0],
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
