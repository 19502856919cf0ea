"""The BA demos' problems.

* The at-scale sparse problem: 10k+ landmarks on a noisy cylinder seen by
  500+ keyframes on a surrounding ring, each point tracked over L
  consecutive cameras facing it. Port of ``demos/demo_ba_at_scale.py:22-80``
  ``build_problem`` (the JAX bench's 10k x 500 configuration,
  bench.py:531-536), with the same numpy draws in the same order, so both
  packages build the same problem from one seed.
* The circle-grid problem: grid points seen from cameras on an arc,
  corrupted by noise (the reference's BA fixture,
  demo-bundle-adj-circle-grid.cpp), which the JAX package's BA tests and
  batch and circle-grid demos take from ``tests/test_ba.py:24-60``; the
  same numpy draws in the same order.

Set-up runs on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom import se3, so3
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.ba.problem import BAProblem, make_problem
from surikatoko_tpu_torch.models.ba.sparse import BAProblemSparse
from surikatoko_tpu_torch.world import scene_gen


def circle_grid_problem(noise_pnt: float = 0.0, noise_rot: float = 0.0,
                        f0: float = 1.0, rng=None, n_angles: int = 4,
                        dtype: torch.dtype | None = None,
                        device: torch.device | str = "cuda"
                        ) -> tuple[BAProblem, np.ndarray, SE3]:
    """Grid points viewed from ``n_angles`` cameras on an arc of a circle
    around the grid, observed exactly, then corrupted: points by
    N(0, noise_pnt), the rotations of frames 1.. (frame 0 is the gauge's
    anchor) by exp(N(0, noise_rot)), drawn from ``rng`` (default
    ``default_rng(7)``) in the JAX fixture's order. Returns (the corrupted
    BAProblem in ``dtype`` (default ``config.default_dtype(device)``) on
    ``device`` (the card by default), the exact points [N,3] as a float64
    numpy array, the exact camera poses, likewise on ``device``)."""
    dtype = dtype or config.default_dtype(device)
    wb = scene_gen.WorldBounds(-2.0, 2.0, -0.5, 0.5, 0.0, 0.5)
    points = scene_gen.generate_grid_points(wb, (0.5, 0.5, 0.5), 0.0).numpy()
    angles = np.linspace(np.pi / 2 - 0.6, np.pi / 2 + 0.6, n_angles)
    cfw = scene_gen.circle_camera_shots((0.0, 0.0, 0.25), 4.0, 3.0, angles)
    K = np.array([[520.0, 0, 160.0], [0, 520.0, 120.0], [0, 0, 1.0]])
    Kf0 = K.copy()
    Kf0[:2] /= f0
    obs = np.zeros((len(points), n_angles, 2))
    mask = np.zeros((len(points), n_angles), bool)
    for j in range(n_angles):
        Rj, tj = cfw.R[j].numpy(), cfw.t[j].numpy()
        xc = points @ Rj.T + tj
        ok = xc[:, 2] > 0.1
        proj = xc @ Kf0.T
        pix = proj[:, :2] / proj[:, 2:3] * f0
        obs[:, j] = pix
        mask[:, j] = (ok & (np.abs(pix[:, 0] - 160) < 400)
                      & (np.abs(pix[:, 1] - 120) < 400))
    rng = rng or np.random.default_rng(7)
    pts_bad = points + (rng.normal(scale=noise_pnt, size=points.shape)
                        if noise_pnt else 0)
    R_bad = cfw.R.numpy().copy()
    if noise_rot:
        for j in range(1, n_angles):   # frame 0 stays exact (gauge anchor)
            R_bad[j] = so3.exp(torch.as_tensor(
                rng.normal(scale=noise_rot, size=3))).numpy() @ R_bad[j]
    if not mask.sum() > 0.8 * mask.size:
        raise ValueError("circle grid: most points must be visible")
    p = make_problem(torch.as_tensor(pts_bad, dtype=dtype, device=device),
                     SE3(torch.as_tensor(R_bad), cfw.t), Kf0, obs, mask, f0)
    return p, points, SE3(cfw.R.to(dtype=dtype, device=device),
                          cfw.t.to(dtype=dtype, device=device))


def build_at_scale_problem(n_points: int, n_frames: int, L: int,
                           noise_pix: float = 0.5, seed: int = 0,
                           dtype: torch.dtype | None = None,
                           device: torch.device | str = "cuda"):
    """Returns (BAProblemSparse in ``dtype`` (default
    ``config.default_dtype(device)``) on ``device`` (the card by default),
    frame_idx [Np,L] int32, obs_mask [Np,L]); the host arrays feed
    SparseBundleAdjustment.set_plan_inputs."""
    dtype = dtype or config.default_dtype(device)
    rng = np.random.default_rng(seed)
    # points on a noisy cylinder, cameras on a surrounding ring
    ang = rng.uniform(0, 2 * np.pi, n_points)
    rad = 2.0 + rng.normal(scale=0.3, size=n_points)
    z = rng.uniform(0, 3.0, n_points)
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], axis=1)

    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    cam_angle = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    eye = np.stack([8.0 * np.cos(cam_angle), 8.0 * np.sin(cam_angle),
                    np.full(n_frames, 1.5)], axis=1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    wfc = se3.look_at_luf_wfc(t(eye), t(np.broadcast_to([0.0, 0, 1.5], eye.shape)),
                              t(np.broadcast_to([0.0, 0, 1.0], eye.shape)))
    # cfw = wfc^-1, its translation as per-frame matrix-vector products:
    # this summation order reproduces the JAX build bit for bit
    Rs = wfc.R.mT.numpy()
    ts = -(Rs @ eye[:, :, None])[..., 0]

    # visibility: each point seen from a contiguous arc of L cameras facing it
    obs = np.zeros((n_points, L, 2))
    fidx = np.zeros((n_points, L), np.int32)
    mask = np.zeros((n_points, L), bool)
    facing = (np.arctan2(pts[:, 1], pts[:, 0]) / (2 * np.pi) * n_frames).astype(int)
    for l in range(L):
        f = (facing + l) % n_frames
        xc = np.einsum("fij,fj->fi", Rs[f], pts) + ts[f]
        ph = xc @ K.T
        pix = ph[:, :2] / ph[:, 2:3]
        obs[:, l] = pix + rng.normal(scale=noise_pix, size=pix.shape)
        fidx[:, l] = f
        mask[:, l] = xc[:, 2] > 0.5

    points = pts + rng.normal(scale=0.01, size=pts.shape)
    tt = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    ps = BAProblemSparse(
        points=tt(points), cfw_R=tt(Rs), cfw_t=tt(ts),
        K=tt(K).expand(n_frames, 3, 3).contiguous(), obs=tt(obs),
        frame_idx=torch.as_tensor(fidx, dtype=torch.int64, device=device),
        obs_mask=torch.as_tensor(mask, device=device), f0=tt(1.0))
    return ps, fidx, mask
