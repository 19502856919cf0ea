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
* ``--ref-source``: another version of the kernel source with the earlier C
  entry point ``symmetric_downdate_f32(P, M, keep, out, D, m, stream)``; it is
  built beside the current one, compared bit for bit on the shapes above and
  timed in turns (ref, new, new, ref) at the main-path shapes.
* ``--flagship-frames N`` runs the K=768 flagship loop for N frames and
  checks the kernel (and the reference build) on that state's (P, B, keep).
* ``--clock-seconds S`` runs the kernel back to back at the flagship shape
  for about S seconds while nvidia-smi samples the SM clock and power.
* the sweep times each tile edge at D = 13 + 6K, m = 2K for K from 16 to 768
  with a 0/1 keep (CUDA events and the profiler's device time).
One JSON line per result on stdout, and also in ``--out`` FILE if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TILES = (32, 128)
SWEEP_K = (16, 32, 48, 64, 96, 128, 160, 192, 224, 256, 320, 384, 512, 768)


def launcher(cov, tile):
    """The wrapper's kernel with a forced tile edge."""
    import torch
    fn = cov._LIB.fn()

    def run(P, M, keep):
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
    return run


def ref_launcher(path: str):
    import torch
    from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
    lib = KernelLibrary(str(Path(path).resolve()), "symmetric_downdate_f32",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn = lib.fn()

    def run(P, M, keep):
        out = torch.empty_like(P)
        rc = fn(P.data_ptr(), M.data_ptr(), None if keep is None else keep.data_ptr(),
                out.data_ptr(), P.shape[0], M.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"reference kernel: CUDA error {rc}")
        return out
    return run, lib


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
          "ptxas": cs.ptxas_summary(cov._LIB)})
    kern = {t: launcher(cov, t) for t in TILES}
    ref = None
    if args.ref_source:
        ref, ref_lib = ref_launcher(args.ref_source)
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
    if sink:
        sink.close()
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
