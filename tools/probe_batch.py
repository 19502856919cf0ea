#!/usr/bin/env python3
"""Probes of kernel B2's batch axis on a CUDA card.

    python3 tools/probe_batch.py tiles [--out FILE]
    python3 tools/probe_batch.py tree DIR LABEL [--out FILE]
    python3 tools/probe_batch.py host FILE [--out FILE]

``tiles``: the batched float32 entry point in PR 4's forms, 32- and
128-wide tiles (``covariance.TILE32``, ``TILE128``), over B = 1 .. 128 at
D = 589 (m = 192, scenario03's shape), D = 109 (m = 32) and D = 1549
(m = 512, B <= 32): graph-replay time of each beside the bound, and whether
the two agree bit for bit (their summation order is the same fmaf chain),
beside the form ``downdate_config`` picks from D and B.
``tools/probe_downdate.py --small`` times every form.

``tree``: one checkout's unbatched B2 and flagship loop, to compare two
checkouts on one card in turns (e.g. the parent commit unpacked with ``git
archive`` into ``_checkout/parent``: run parent, this tree, this tree,
parent). B2 at (589,192) and (4621,1536) with keep: CUDA events, graph
replay, device time, and the host's time to enqueue a call (host clock over
back-to-back calls, the median of 5 runs); then the flagship loop of
chip_smoke.py (120 timed frames after 120 warm-up frames): fps and ATE. The
checkout's own chip_smoke.py and package are imported.

``host``: the host's time to enqueue one unbatched B2 call through this
tree's wrapper and through another source of ``ops/covariance.py`` (FILE,
e.g. the parent's from ``git show``), both loaded in one process and timed
in turns (10 rounds of back-to-back calls each, medians), at (589,192) and
(4621,1536) with keep. Both launch this tree's kernel library; the other
source's dispatcher operator is registered under another name.

One JSON line per measurement, and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def emit(obj, out) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def tiles(out) -> None:
    import torch
    import chip_smoke as c
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.ops import covariance as cov
    dev = torch.device("cuda", 0)
    config.set_full_precision()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = n_sm * c.F32_LANES_PER_SM * float(
        c.nvidia_smi("clocks.max.sm", units=False)) * 1e6

    def call(P, M, keep, form):
        B, m, D = M.shape
        res = torch.empty((B, D, D), device=dev)
        scratch = (torch.empty((B, m, -(-D // 4) * 4), device=dev)
                   if cov.F32_FORMS[form].padded else None)
        rc = cov._LIB.fn()(P.data_ptr(), M.data_ptr(), keep.data_ptr(),
                            None if scratch is None else scratch.data_ptr(),
                            res.data_ptr(), B, D, m, form, D * D, m * D, D,
                            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return res

    for D, m, batches in ((589, 192, (1, 2, 4, 8, 16, 32, 64, 128)),
                          (109, 32, (1, 2, 4, 8, 16, 32, 64, 128)),
                          (1549, 512, (1, 2, 4, 8, 16, 32))):
        for B in batches:
            P, M, keep = c.batch_downdate_case(B, D, m, dev, torch.float32)
            forms = {32: cov.TILE32, 128: cov.TILE128}
            equal = torch.equal(call(P, M, keep, cov.TILE32),
                                call(P, M, keep, cov.TILE128))
            fma, nbytes = c.downdate_work(D, m, True)
            b_ms, b_by = c.bound_ms(B * fma, B * nbytes, rate)
            g = {t: c.cuda_graph_ms(lambda f=f: call(P, M, keep, f), 20)
                 for t, f in forms.items()}
            config = cov.downdate_config(D, B=B, sms=n_sm)
            emit({"probe": "tiles", "D": D, "m": m, "B": B,
                  "tile_of_config": config.tile,
                  "form_of_config": cov.F32_FORMS[config.form].name,
                  "bitwise_equal": equal, "graph_ms_32": g[32],
                  "graph_ms_128": g[128], "bound_ms": b_ms, "bound_by": b_by,
                  "pct_of_bound_32": 100 * b_ms / g[32],
                  "pct_of_bound_128": 100 * b_ms / g[128]}, out)


def tree(root: str, label: str, out) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    import chip_smoke as c
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    from surikatoko_tpu_torch.ops import covariance as cov
    from surikatoko_tpu_torch.ops import ncc_cuda
    dev = torch.device("cuda", 0)
    config.set_full_precision()
    cov.build()
    ncc_cuda.build()
    res = {"probe": "tree", "tree": label, "package": str(Path(cov.__file__)
                                                         .parents[1])}
    for D, m in ((589, 192), (4621, 1536)):
        P, M, keep = c.downdate_case(D, m, True, dev)
        f = lambda: cov.symmetric_downdate(P, M, keep)  # noqa: E731
        n = 400 if D < 1000 else 40
        row = {"events_ms": c.cuda_ms(f, n), "graph_ms": c.cuda_graph_ms(f, n // 4),
               "device_us": c.device_us_per_call(f)}
        reps = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                f()
            reps.append(1e6 * (time.perf_counter() - t0) / n)
            torch.cuda.synchronize()
        row["host_enqueue_us"] = sorted(reps)[2]
        row["host_enqueue_us_reps"] = reps
        res[f"{D}x{m}"] = row
    params, sc = c.flagship_setup(dev)
    _, out_loop, _, dt, _ = c.run_loop(params, sc, True, dev)
    res["flagship_fps"] = len(c.TIMED_FRAMES) / dt
    res["flagship_ate"] = float(aligned_rmse(
        out_loop[2][2].double(),
        c.gt_positions(sc, list(c.TIMED_FRAMES)).double()))
    emit(res, out)


def host(ref: str, out) -> None:
    import importlib.util
    import torch
    import chip_smoke as c
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.ops import covariance as cov
    dev = torch.device("cuda", 0)
    config.set_full_precision()
    text = Path(ref).read_text().replace('"surikatoko::symmetric_downdate"',
                                         '"surikatoko::symmetric_downdate_other"')
    spec = importlib.util.spec_from_loader("covariance_other", loader=None)
    other = importlib.util.module_from_spec(spec)
    exec(compile(text, ref, "exec"), other.__dict__)
    cov.build()
    res = {"probe": "host", "other": ref}
    for D, m in ((589, 192), (4621, 1536)):
        P, M, keep = c.downdate_case(D, m, True, dev)
        fns = {"this": lambda: cov.symmetric_downdate(P, M, keep),
               "other": lambda: other.symmetric_downdate(P, M, keep)}
        equal = torch.equal(fns["this"](), fns["other"]())
        n = 2000 if D < 1000 else 40
        reps = {k: [] for k in fns}
        for _ in range(10):
            for k, f in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    f()
                reps[k].append(1e6 * (time.perf_counter() - t0) / n)
                torch.cuda.synchronize()
        res[f"{D}x{m}"] = {"bitwise_equal": equal, **{
            f"host_enqueue_us_{k}": sorted(v)[len(v) // 2] for k, v in reps.items()},
            **{f"host_enqueue_us_{k}_reps": v for k, v in reps.items()}}
    emit(res, out)


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="probe", required=True)
    t = sub.add_parser("tiles")
    t.add_argument("--out", default=None)
    r = sub.add_parser("tree")
    r.add_argument("dir")
    r.add_argument("label")
    r.add_argument("--out", default=None)
    h = sub.add_parser("host")
    h.add_argument("file")
    h.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.probe in ("tiles", "host"):
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        if args.probe == "tiles":
            tiles(args.out)
        else:
            host(args.file, args.out)
    else:
        tree(args.dir, args.label, args.out)
    import chip_smoke as c
    print(c.nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
