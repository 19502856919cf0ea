#!/usr/bin/env python3
"""Chart where the two bad-ellipsoid criteria part, frame by frame.

The host-driven tracker deletes a landmark whose propagated 3x3 position
covariance is not positive definite (``health.bad_uncertainty_mask``). The
port tests that by the three pivots of the 3x3 Cholesky factorization; the
JAX package (surikatoko_tpu/models/monoslam/health.py:100-107) by the three
leading minors, whose third (det3) cancels to rounding for an elongated
covariance. This tool runs the port's host-driven tracker on chip_smoke's
hostloop world (``chip_smoke.hostloop_runner``: scenario03's K = 96 world,
MonoSlamFilter(update_impl=1), the GT matcher with noise 0.5 from
default_rng(3)) on the CPU, in float64 unless ``--dtype`` says otherwise,
and at every frame evaluates both
criteria on the same P: the port's mask drives the run, the minors' mask (a
numpy copy of the JAX test, on the same propagated covariances) is only
recorded. Every active landmark where the two differ is logged with its
frame, slot, rho, the minors (a, det2, det3), the pivots (a, p2, p3), det3
relative to its terms' scale, its covariance and that covariance's
eigenvalues (in float64).

    python3 tools/chart_bad_ellipsoid.py [--frames 300] [--dtype float64]
        [--out FILE]

prints one JSON line per differing landmark (also to FILE) and a summary
line last. Needs only the port (torch, numpy).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from surikatoko_tpu_torch.models.monoslam import health  # noqa: E402


def minors_mask(covs: np.ndarray) -> tuple[np.ndarray, dict]:
    """The JAX package's test on [K,3,3] covariances: bad unless finite
    and a > 0, det2 > 0, det3 > 0 (Sylvester's minors). Returns (bad [K],
    the minors and det3's terms' scale)."""
    a, b, c = covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2]
    d, e, f = covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]
    det2 = a * d - b * b
    t1, t2, t3 = a * (d * f - e * e), b * (b * f - e * c), c * (b * e - d * c)
    det3 = t1 - t2 + t3
    finite = np.isfinite(covs.reshape(len(covs), -1)).all(axis=-1)
    pd = (a > 0) & (det2 > 0) & (det3 > 0)
    return ~(finite & pd), {"a": a, "det2": det2, "det3": det3,
                            "det3_scale": np.abs(t1) + np.abs(t2) + np.abs(t3)}


@np.errstate(invalid="ignore", divide="ignore")
def pivots(covs: np.ndarray) -> np.ndarray:
    """The port's three Cholesky pivots of each [3,3] covariance (nan for a
    free slot's zero covariance)."""
    a, b, c = covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2]
    d, e, f = covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]
    p2 = d - b * b / a
    l32 = e - b * c / a
    return np.stack([a, p2, f - c * c / a - l32 * l32 / p2], axis=-1)


def chart(n_frames: int, dtype: torch.dtype = torch.float64
          ) -> tuple[list, dict]:
    """Run the hostloop world for ``n_frames`` in ``dtype`` on the CPU with
    the port's criterion and chart the JAX one beside it. Returns
    (differing landmarks, summary)."""
    log, counts = [], {"frames": 0, "evaluated": 0, "port_bad": 0,
                       "minors_bad": 0, "differ": 0,
                       "min_det3_rel": float("inf"),
                       "det3_rel_below_1e-12": 0,
                       "min_pivot3_over_largest_eigval": float("inf")}
    port_mask = health.bad_uncertainty_mask

    def charted(x, P, capacity, substitute_rho, repres=health.REPRES_SPHERICAL):
        bad_port = port_mask(x, P, capacity, substitute_rho, repres)
        _, covs = health.landmark_pos_covariances(x, P, capacity,
                                                  substitute_rho, repres)
        covs = covs.detach().cpu().numpy()
        bad_minors, m = minors_mask(covs)
        frame = counts["frames"]
        counts["frames"] += 1
        # the filter counts only active landmarks: the state's lm_active is
        # not passed in, so slots whose covariance is all zero (free) are
        # left out here as they are bad under both tests
        live = np.abs(covs).reshape(capacity, -1).max(axis=-1) > 0
        port = bad_port.cpu().numpy()
        counts["evaluated"] += int(live.sum())
        counts["port_bad"] += int((port & live).sum())
        counts["minors_bad"] += int((bad_minors & live).sum())
        piv = pivots(covs)
        # how near the minors' test came to rounding: det3 against the
        # scale of its terms, and the last pivot against the covariance's
        # largest eigenvalue, over live landmarks good under both tests
        good = live & ~port & ~bad_minors
        if good.any():
            rel = m["det3"][good] / m["det3_scale"][good]
            counts["min_det3_rel"] = min(counts["min_det3_rel"],
                                         float(rel.min()))
            counts["det3_rel_below_1e-12"] += int((rel < 1e-12).sum())
            top = np.abs(np.linalg.eigvalsh(covs[good])).max(axis=-1)
            counts["min_pivot3_over_largest_eigval"] = min(
                counts["min_pivot3_over_largest_eigval"],
                float((piv[good, 2] / top).min()))
        lms = x[health._N:].reshape(capacity, 6).detach().cpu().numpy()
        for k in np.flatnonzero(live & (port != bad_minors)):
            counts["differ"] += 1
            log.append({
                "frame": frame, "slot": int(k), "rho": float(lms[k, 5]),
                "port_bad": bool(port[k]), "minors_bad": bool(bad_minors[k]),
                "a": float(m["a"][k]), "det2": float(m["det2"][k]),
                "det3": float(m["det3"][k]),
                "det3_rel": float(m["det3"][k] / m["det3_scale"][k]),
                "pivots": piv[k].tolist(),
                "eigvals": np.linalg.eigvalsh(covs[k].astype(np.float64)
                                              ).tolist(),
                "cov": covs[k].tolist()})
        return bad_port

    health.bad_uncertainty_mask = charted
    try:
        run, _ = chip_smoke.hostloop_runner("cpu", dtype)
        res = run(n_frames)
    finally:
        health.bad_uncertainty_mask = port_mask
    counts["deleted_total"] = int(sum(int(s.deleted_count) for s in res.stats))
    counts["frames_with_a_difference"] = len({r["frame"] for r in log})
    return log, counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    torch.set_num_threads(4)
    log, summary = chart(args.frames, getattr(torch, args.dtype))
    lines = [json.dumps(r) for r in log] + [json.dumps({"summary": summary})]
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
