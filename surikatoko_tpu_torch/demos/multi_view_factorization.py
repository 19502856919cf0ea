"""Incremental multi-view factorization demo.

Port of ``demos/demo_multi_view_factorization.py`` (reference
demos/demo-multi-view-factorization.cpp): synthetic rectangular-path world,
GT-projecting corners matcher, first two frames carry known pose+points
("well_known_frames"), then per-frame IntegrateNewFrameCorners with BA
triggering. fake_localization/fake_mapping switches mirror the reference
flags. ``loop_closure`` adds GT-measured relative-pose edges (last frame vs
the two bootstrap frames) and runs SE(3) pose-graph optimization + map
re-triangulation + fixed-keyframe BA (closure frames pinned) after the
sequence: the drift-correction path the reference lacks.

    python -m surikatoko_tpu_torch.demos.multi_view_factorization \
        [--frames 12] [--noise_pix 0] [--loop_closure] [--fake_localization]
        [--fake_mapping] [--seed 0] [--device cuda] [--dtype float32]

prints one JSON line of :func:`run`'s metrics.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom.align import aligned_rmse
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.mvf import MultiViewFactorizer, TrackStore
from surikatoko_tpu_torch.world import scene_gen

K = np.array([[520.0, 0, 160.0], [0, 520.0, 120.0], [0, 0, 1.0]])
IMAGE_SIZE = (320, 240)


def make_world(frames: int):
    """(points [N,3], gt cfw R [F,3,3], gt cfw t [F,3]) host float64: the
    grid world and the rectangular path of the reference demo (:383-460)."""
    wb = scene_gen.WorldBounds(-1.5, 1.5, -1.5, 1.5, 0.0, 0.2)
    points = scene_gen.generate_grid_points(wb, (0.4, 0.4, 0.4), 0.1).numpy()
    gt = scene_gen.rectangular_path(wb, frames // 4 + 1, frames // 4 + 1,
                                    (3, -2, 5), (0, 0, 0), (0, 0, 1))
    return points, gt.R.numpy(), gt.t.numpy()


def ate(est, gt) -> float:
    """Umeyama-aligned RMSE of two host point sets, in float64."""
    return float(aligned_rmse(torch.as_tensor(est, dtype=torch.float64),
                              torch.as_tensor(gt, dtype=torch.float64)))


def camera_positions(R, t) -> np.ndarray:
    """[F,3] camera centres of cfw poses (host arrays)."""
    return np.stack([-(Rf.T @ tf) for Rf, tf in zip(R, t)])


def run_factorizer(frames: int = 12, noise_pix: float = 0.0,
                   loop_closure: bool = False,
                   fake_localization: bool = False,
                   fake_mapping: bool = False, seed: int = 0,
                   device: torch.device | str = "cuda",
                   dtype: torch.dtype | None = None, **mvf_kw):
    """(factorizer, metrics) of one demo run; see :func:`run`. ``mvf_kw``
    go to the factorizer (e.g. ``use_sparse_ba``, ``ba_group``)."""
    dtype = dtype or config.default_dtype(device)
    points, R_gt, t_gt = make_world(frames)
    n_frames = min(frames, R_gt.shape[0])
    K_inv = np.linalg.inv(K)
    img_w, img_h = IMAGE_SIZE
    ts = TrackStore(max_tracks=len(points), max_frames=n_frames)
    mvf = MultiViewFactorizer(
        track_store=ts, K=K, fake_localization=fake_localization,
        fake_mapping=fake_mapping,
        gt_cfw_fun=lambda f: SE3(R_gt[f], t_gt[f]),
        gt_point_fun=lambda tid: points[tid], device=device, dtype=dtype,
        **mvf_kw)
    rng = np.random.default_rng(seed)

    def write_frame_corners(f):
        xc = points @ R_gt[f].T + t_gt[f]
        vis = xc[:, 2] > 1e-6
        ph = xc @ K.T
        pix = ph[:, :2] / ph[:, 2:3]
        if noise_pix:
            pix = pix + rng.normal(scale=noise_pix, size=pix.shape)
        vis &= ((pix[:, 0] >= 0) & (pix[:, 0] < img_w) & (pix[:, 1] >= 0)
                & (pix[:, 1] < img_h))
        for tid in np.nonzero(vis)[0]:
            ts.add_corner(int(tid), f, pix[tid], K_inv)
        return np.nonzero(vis)[0]

    t0 = time.perf_counter()
    integrated = []
    for f in range(n_frames):
        vis_ids = write_frame_corners(f)
        if f < 2:  # well-known frames
            mvf.add_known_frame(SE3(R_gt[f], t_gt[f]))
            for tid in vis_ids:
                mvf.set_known_point(int(tid), points[tid])
            continue
        integrated.append(bool(mvf.integrate_new_frame_corners()))

    gt_pos = camera_positions(R_gt[:n_frames], t_gt[:n_frames])
    end_before = end_after = None
    if loop_closure:
        closures = []
        i = n_frames - 1
        for j in (0, 1):
            rel_R = R_gt[j] @ R_gt[i].T
            closures.append((i, j, SE3(rel_R, t_gt[j] - rel_R @ t_gt[i]), 3.0))
        end_err = lambda: float(np.linalg.norm(camera_positions(
            mvf.cam_cfw_R[-1:], mvf.cam_cfw_t[-1:])[0] - gt_pos[-1]))
        end_before = end_err()
        mvf.apply_pose_graph(closures, run_ba=True)  # BA with pinned closures
        end_after = end_err()
    seconds = time.perf_counter() - t0

    tids = sorted(mvf.point_coords)
    est = np.stack([mvf.point_coords[t] for t in tids])
    return mvf, {
        "frames": n_frames, "noise_pix": noise_pix,
        "loop_closure": loop_closure, "seed": seed,
        "device": str(torch.device(device)), "dtype": str(dtype),
        "integrated": integrated, "points": len(tids),
        "point_ate": ate(est, points[tids]),
        "camera_ate": ate(camera_positions(mvf.cam_cfw_R, mvf.cam_cfw_t),
                          gt_pos),
        "ba_runs": mvf.ba_runs, "ba_log": list(mvf.ba_log),
        "end_err_before_closure": end_before,
        "end_err_after_closure": end_after, "seconds": seconds}


def run(frames: int = 12, noise_pix: float = 0.0, loop_closure: bool = False,
        fake_localization: bool = False, fake_mapping: bool = False,
        seed: int = 0, device: torch.device | str = "cuda",
        dtype: torch.dtype | None = None) -> dict:
    """The demo on the card (unless ``device`` says otherwise) in ``dtype``
    (default ``config.default_dtype(device)``). Returns its metrics: point
    and camera ATE (Umeyama-aligned RMSE against the GT), the point count,
    ``ba_runs`` and each BA's (kind, ok, stop reason, iterations, trials),
    and with ``loop_closure`` the last camera's position error before and
    after the closure."""
    return run_factorizer(frames, noise_pix, loop_closure, fake_localization,
                          fake_mapping, seed, device, dtype)[1]


def run_map(frames: int = 12, noise_pix: float = 0.0, seed: int = 0,
            device: torch.device | str = "cuda",
            dtype: torch.dtype | None = None, group=None, **mvf_kw):
    """(track ids, their points [N,3], camera positions [F,3], metrics) of
    a demo run without closure; ``group`` point-shards its sparse BA over a
    process group (``MultiViewFactorizer.ba_group``), the run of every rank
    of it being the same."""
    mvf, metrics = run_factorizer(frames, noise_pix, seed=seed, device=device,
                                  dtype=dtype, ba_group=group, **mvf_kw)
    tids = sorted(mvf.point_coords)
    return (np.asarray(tids), np.stack([mvf.point_coords[t] for t in tids]),
            camera_positions(mvf.cam_cfw_R, mvf.cam_cfw_t), metrics)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--fake_localization", action="store_true")
    ap.add_argument("--fake_mapping", action="store_true")
    ap.add_argument("--noise_pix", type=float, default=0.0,
                    help="detection noise std (pixels)")
    ap.add_argument("--loop_closure", action="store_true",
                    help="pose-graph loop closure after the sequence")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    args = ap.parse_args()
    config.set_full_precision()
    print(json.dumps(run(
        args.frames, args.noise_pix, args.loop_closure,
        args.fake_localization, args.fake_mapping, args.seed, args.device,
        getattr(torch, args.dtype) if args.dtype else None)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
