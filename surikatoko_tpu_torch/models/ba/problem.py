"""BA problem container + f0-scaled reprojection error.

Port of ``surikatoko_tpu/models/ba/problem.py``. The data layout is a dense
(points x frames) observation grid with a mask; models/ba/sparse.py holds
the track-major layout for large problems.

Error convention (reference ReprojErrorWithOverlap, bundle-adj-kanatani.cpp
:410-490): with K already f0-scaled (rows 0,1 divided by f0), for
observation (i,j):
    x_h = K_j (R_j X_i + T_j);   err += |x_h[:2]/x_h[2] - pix_ij/f0|^2
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from surikatoko_tpu_torch.geom.se3 import SE3


class BAProblem(NamedTuple):
    points: torch.Tensor     # [Np, 3] world points
    cfw_R: torch.Tensor      # [F, 3, 3] camera-from-world rotations
    cfw_t: torch.Tensor      # [F, 3]
    K: torch.Tensor          # [F, 3, 3] f0-scaled intrinsics
    obs: torch.Tensor        # [Np, F, 2] observed pixels (raw, unscaled)
    obs_mask: torch.Tensor   # [Np, F] bool
    f0: torch.Tensor         # scalar

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_frames(self) -> int:
        return self.cfw_R.shape[0]


def make_problem(points, cfw: SE3, K, obs, obs_mask, f0=1.0) -> BAProblem:
    """Dtype and device from ``points``."""
    points = torch.as_tensor(points)
    dtype, device = points.dtype, points.device
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    K = t(K)
    if K.ndim == 2:
        K = K.expand(cfw.R.shape[0], 3, 3).contiguous()
    return BAProblem(points=points, cfw_R=t(cfw.R), cfw_t=t(cfw.t), K=K,
                     obs=t(obs),
                     obs_mask=torch.as_tensor(obs_mask, dtype=torch.bool,
                                              device=device),
                     f0=t(f0))


def project_f0(K: torch.Tensor, cfw_R: torch.Tensor, cfw_t: torch.Tensor,
               X: torch.Tensor) -> torch.Tensor:
    """Project world point(s) to f0-units image coords: x_h[:2]/x_h[2]."""
    x_cam = torch.einsum("...ij,...j->...i", cfw_R, X) + cfw_t
    x_h = torch.einsum("...ij,...j->...i", K, x_cam)
    return x_h[..., :2] / x_h[..., 2:3]


def residuals(p: BAProblem) -> torch.Tensor:
    """Masked residual grid [Np, F, 2] in f0 units."""
    proj = project_f0(p.K[None, :], p.cfw_R[None, :], p.cfw_t[None, :],
                      p.points[:, None, :])
    r = proj - p.obs / p.f0
    return r * p.obs_mask[..., None].to(r.dtype)


def reproj_error(p: BAProblem) -> torch.Tensor:
    """Scalar f0-scaled squared reprojection error (reference ReprojError)."""
    r = residuals(p)
    return torch.sum(r * r)


def seen_points_count(p: BAProblem) -> torch.Tensor:
    return torch.sum(p.obs_mask.to(torch.int64))


def reproj_error_pix_per_point(p: BAProblem, err=None) -> torch.Tensor:
    """Error expressed as pixels per seen point (reference
    ReprojErrorPixPerPoint): sqrt(err / count) * f0."""
    if err is None:
        err = reproj_error(p)
    n = torch.clamp(seen_points_count(p), min=1)
    return torch.sqrt(err / n) * p.f0
