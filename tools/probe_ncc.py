#!/usr/bin/env python3
"""Probe of the NCC search kernel (csrc/ncc_search.cu) on one CUDA card:
ptxas's report, a device-time sweep of its tiling at the main path's
(K, T, S) = (768, 15, 15), and a timing against another version of the
source.

    python3 tools/probe_ncc.py [--ref-source FILE] [--no-sweep] [--out FILE]

* every tiling of the sweep (cells per thread 4 or 8, landmarks, one warp
  each, per block 1-8) is held to ``chip_smoke.compare`` on
  random data at (768, 15, 15), then timed by the profiler's device time
  and by CUDA-graph replay; the entry point's own tiling is marked.
* ``--ref-source``: another version of the source with the same C entry
  point ``ncc_surface_argmax_f32`` (e.g. an earlier commit's, from ``git
  show``); it is built beside the current one, held to the same check on
  the test shapes, and timed in turns (ref, new, new, ref) at (768, 15, 15).
One JSON line per result on stdout, and also in ``--out`` FILE if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SWEEP = [(c, lpb) for c in (4, 8) for lpb in (1, 2, 4, 8)]
ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4


def as_module(fn, ncc_cuda):
    """``fn`` in the place of the wrapper, for ``chip_smoke.compare``."""
    return types.SimpleNamespace(ncc_surface_argmax=fn,
                                 ncc_surface_argmax_ref=ncc_cuda.ncc_surface_argmax_ref)


def launcher(fn, *tiling):
    """A call of the C function ``fn`` on torch tensors; ``tiling`` are the
    tiled entry point's extra arguments."""
    import torch

    def run(p, t, g, with_neigh=False):
        K, P, T = p.shape[0], p.shape[1], t.shape[-1]
        corr = torch.empty(K, device=p.device)
        idx = torch.empty(K, dtype=torch.int32, device=p.device)
        nb = torch.empty((K, 4), device=p.device) if with_neigh else None
        rc = fn(p.data_ptr(), t.data_ptr(), g.data_ptr(), corr.data_ptr(),
                idx.data_ptr(), None if nb is None else nb.data_ptr(), K, P, T,
                int(with_neigh), *tiling, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"tiling {tiling}: CUDA error {rc}")
        return (corr, idx) if nb is None else (corr, idx, nb)
    return run


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-source")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_ncc: no CUDA device", file=sys.stderr)
        return 1
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.ops import ncc_cuda
    from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
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

    tiled = getattr(ctypes.CDLL(str(ncc_cuda.build())), "ncc_surface_argmax_tiled_f32")
    tiled.argtypes = ARGS + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    tiled.restype = ctypes.c_int
    emit({"probe": "env", "nvidia_smi": cs.nvidia_smi("name,power.limit"),
          "clocks_max_sm": cs.nvidia_smi("clocks.max.sm"),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": cs.ptxas_summary(ncc_cuda._LIB)})
    rng = np.random.default_rng(0)
    p, t, g = cs.random_case(rng, 768, 15, 15, dev)
    new = lambda: ncc_cuda.ncc_surface_argmax(p, t, g)
    ok = True

    if args.ref_source:
        lib = KernelLibrary(str(Path(args.ref_source).resolve()),
                            "ncc_surface_argmax_f32", ARGS + [ctypes.c_void_p])
        ref = launcher(lib.fn())
        emit({"probe": "ref_build", "source": args.ref_source,
              "ptxas": cs.ptxas_summary(lib)})
        for K, T, S in cs.TEST_SHAPES:
            case = cs.random_case(rng, K, T, S, dev)
            for with_neigh in (False, True):
                err, agree, c_ok, _ = cs.compare(as_module(ref, ncc_cuda), *case,
                                                 with_neigh)
                ok &= c_ok
                emit({"probe": "ref_check", "K": K, "T": T, "S": S,
                      "with_neigh": with_neigh, "max_abs_err": err,
                      "idx_agreement": agree, "ok": c_ok})
        old = lambda: ref(p, t, g)
        tm = {"ref": [], "new": []}
        for name, f in (("ref", old), ("new", new), ("new", new), ("ref", old)):
            tm[name].append(cs.cuda_graph_ms(f, 200))
        emit({"probe": "ref_vs_new", "K": 768, "T": 15, "S": 15,
              "graph_ms": tm, "device_us": {"ref": cs.device_us_per_call(old),
                                            "new": cs.device_us_per_call(new)}})

    if not args.no_sweep:
        rows = []
        for tiling in SWEEP:
            run = launcher(tiled, *tiling)
            err, agree, c_ok, _ = cs.compare(as_module(run, ncc_cuda), p, t, g, True)
            ok &= c_ok
            rows.append({"probe": "sweep", "cells": tiling[0],
                         "landmarks_per_block": tiling[1], "ok": c_ok,
                         "max_abs_err": err, "idx_agreement": agree,
                         "device_us": cs.device_us_per_call(lambda: run(p, t, g)),
                         "graph_ms": cs.cuda_graph_ms(lambda: run(p, t, g), 200)})
            emit(rows[-1])
        best = min(rows, key=lambda r: r["graph_ms"])
        emit({"probe": "sweep_best", **{k: best[k] for k in (
            "cells", "landmarks_per_block", "graph_ms")},
            "entry_point_graph_ms": cs.cuda_graph_ms(new, 200)})
    if sink:
        sink.close()
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
