#!/usr/bin/env python3
"""Probes of the multi-view factorization pipeline, on one CUDA card unless
``--device cpu`` is given.

    python3 tools/probe_mvf.py [--device cuda] [--no-closure] [--out FILE]

* ``so3``: the MVF demo's world (12 frames, 0.5 px, the SE(3) closure with
  frames 0, 1 and 11 pinned in its BA), in float64, and in float32 with and
  without the factorizer's projection of each global BA's rotations onto
  SO(3) (without it: the JAX package's handling). For each: the rotations'
  largest departure from SO(3) before the closure, how far the closure BA
  moved its pinned cameras (in the result it returned, kept or dropped),
  that BA's (ok, stop reason, iterations), the point ATE and the last
  camera's error after the closure.
* ``closure``: ``demos.mvf_at_scale.run_at_scale`` at its defaults (10k
  points, 500 + 12 frames, float32) with the factorizer kept just before
  its Sim(3) closure; the closure is run again on copies of that state: as
  the pipeline runs it, with the graph and the re-triangulation in float64,
  with the host-loop LM, and with 200 iterations. For each: the LM's stop
  code, iterations, trials and graph error before and after, and the
  trajectory ATE after the closure.
One JSON line per result on stdout, and also in ``--out`` FILE if given.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from surikatoko_tpu_torch import config  # noqa: E402
from surikatoko_tpu_torch.demos import multi_view_factorization as demo  # noqa: E402
from surikatoko_tpu_torch.demos import mvf_at_scale as mas  # noqa: E402
from surikatoko_tpu_torch.models.ba import lm_device  # noqa: E402
from surikatoko_tpu_torch.models.mvf import factorizer  # noqa: E402

CLOSURE_VARIANTS = {"f32_device_loop": {},
                    "f64_device_loop": {"dtype": torch.float64},
                    "f32_host_loop": {"ba_device_loop": False},
                    "f32_200_iters": {"iters": 200}}


def so3_departure(R_list) -> float:
    R = np.stack(R_list).astype(np.float64)
    return float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())


def probe_so3(device) -> list:
    out = []
    run_ba = factorizer.MultiViewFactorizer.run_global_ba
    compute = factorizer.BundleAdjustment.compute_inplace
    for name, dtype, project in (("f64", torch.float64, True),
                                 ("f32", torch.float32, True),
                                 ("f32_unprojected", torch.float32, False)):
        seen = {}

        def recording_global_ba(self, pin_frames=()):
            if pin_frames:
                seen["departure_before"] = so3_departure(self.cam_cfw_R)
            run_ba(self, pin_frames)
            if pin_frames:
                seen["closure_ba"] = self.ba_log[-1][1:4]

        def recording_compute(self, p, term=None):
            ok, p_opt = compute(self, p, term)
            if self.pin_frames:      # the closure's BA, its result kept or not
                moved = (p_opt.cfw_t - p.cfw_t).abs().amax(dim=1)
                seen["pinned_moved"] = {int(f): float(moved[f])
                                        for f in self.pin_frames}
            return ok, p_opt

        factorizer.MultiViewFactorizer.run_global_ba = recording_global_ba
        factorizer.BundleAdjustment.compute_inplace = recording_compute
        nearest = factorizer._nearest_rotations
        if not project:
            factorizer._nearest_rotations = lambda R: R
        try:
            _, res = demo.run_factorizer(12, 0.5, True, seed=0, device=device,
                                         dtype=dtype)
        finally:
            factorizer.MultiViewFactorizer.run_global_ba = run_ba
            factorizer.BundleAdjustment.compute_inplace = compute
            factorizer._nearest_rotations = nearest
        out.append({"probe": "so3", "run": name, **seen,
                    "point_ate": res["point_ate"],
                    "end_err_after_closure": res["end_err_after_closure"]})
    return out


def probe_closure(device) -> list:
    kept = {}
    close = factorizer.MultiViewFactorizer.close_loop_sim3

    def keeping_close(self, *a, **kw):
        kept["mvf"], kept["call"] = copy.deepcopy(self), (a, kw)
        return close(self, *a, **kw)

    factorizer.MultiViewFactorizer.close_loop_sim3 = keeping_close
    try:
        res = mas.run_at_scale(mas.make_args(device=device, oracle_pairs=True,
                                             dtype=torch.float32))
    finally:
        factorizer.MultiViewFactorizer.close_loop_sim3 = close
    out = [{"probe": "closure", "run": "pipeline",
            **{k: res[k] for k in ("traj_ate_pre_closure",
                                   "traj_ate_post_closure", "traj_ate_rmse",
                                   "map_ate_rmse", "closure_inliers")}}]
    world = mas.World(mas.make_args())
    pos_gt = demo.camera_positions(world.Rs, world.ts_gt)
    lm_runs = []
    run_lm = lm_device.run_lm_on_device

    def recording_run_lm(p0, **kw):
        err0 = float(kw["err_fn"](p0))
        r = run_lm(p0, **kw)
        lm_runs.append({"stop_code": r[1], "iters": r[2], "err0": err0,
                        "err": r[3], "trials": r[4]})
        return r

    lm_device.run_lm_on_device = recording_run_lm
    try:
        a, kw = kept["call"]
        for name, v in CLOSURE_VARIANTS.items():
            m = copy.deepcopy(kept["mvf"])
            m.dtype = v.get("dtype", m.dtype)
            m.ba_device_loop = v.get("ba_device_loop", m.ba_device_loop)
            lm_runs.clear()
            ok, n = close(m, *a, **{**kw, "iters": v.get("iters", 40)})
            out.append({"probe": "closure", "run": name, "ok": ok,
                        "pairs": n, "inliers": m.last_closure_inliers,
                        "traj_ate_after": demo.ate(demo.camera_positions(
                            m.cam_cfw_R, m.cam_cfw_t), pos_gt),
                        "lm": list(lm_runs)})
    finally:
        lm_device.run_lm_on_device = run_lm
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-closure", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("probe_mvf: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 1
        config.set_full_precision()
    lines = probe_so3(args.device)
    if not args.no_closure:
        lines += probe_closure(args.device)
    texts = [json.dumps(line) for line in lines]
    print("\n".join(texts), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(texts) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
