"""The at-scale sparse BA problem: 10k+ landmarks on a noisy cylinder seen by
500+ keyframes on a surrounding ring, each point tracked over L consecutive
cameras facing it.

Port of ``demos/demo_ba_at_scale.py:22-80`` ``build_problem`` (the JAX
bench's 10k x 500 configuration, bench.py:531-536), with the same numpy
draws in the same order, so both packages build the same problem from one
seed. Set-up runs on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch.geom import se3
from surikatoko_tpu_torch.models.ba.sparse import BAProblemSparse


def build_at_scale_problem(n_points: int, n_frames: int, L: int,
                           noise_pix: float = 0.5, seed: int = 0,
                           dtype: torch.dtype = torch.float64,
                           device: torch.device | str | None = None):
    """Returns (BAProblemSparse in ``dtype`` on ``device``, frame_idx
    [Np,L] int32, obs_mask [Np,L]); the host arrays feed
    SparseBundleAdjustment.set_plan_inputs."""
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
