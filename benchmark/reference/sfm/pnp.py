"""A keyframe's pose as the least-squares optimum of its 2D-3D
correspondences (perspective-n-point), by Gauss-Newton on the normalized
reprojection residuals.

Departure from the published description: the residual is in normalized
coordinates rather than pixels; with fx = fy, as in the configurations
here, the two costs differ by a constant factor and share their optimum."""

from __future__ import annotations

import torch

from .geometry import rodrigues, skew

ITERS = 30          # from the previous keyframe's pose: converged long before


def pnp_gn(X: torch.Tensor, obs: torch.Tensor, R0: torch.Tensor,
           t0: torch.Tensor, iters: int = ITERS):
    """(R, t) camera-from-world minimizing sum |x(R X + t) - obs|^2, where
    x(.) is a camera point's normalized coordinates; X [N, 3], obs [N, 2],
    from (R0, t0). The pose moves as R <- exp(w) R, t <- t + dt."""
    R, t = R0, t0
    for _ in range(iters):
        y = X @ R.T
        xc = y + t
        z = xc[:, 2]
        r = (xc[:, :2] / z[:, None] - obs).reshape(-1)
        dproj = torch.zeros(X.shape[0], 2, 3, dtype=X.dtype, device=X.device)
        dproj[:, 0, 0] = 1.0 / z
        dproj[:, 1, 1] = 1.0 / z
        dproj[:, 0, 2] = -xc[:, 0] / (z * z)
        dproj[:, 1, 2] = -xc[:, 1] / (z * z)
        J = torch.cat([-dproj @ skew(y), dproj], dim=-1).reshape(-1, 6)
        d = torch.linalg.solve(J.T @ J, -(J.T @ r))
        R = rodrigues(d[:3]) @ R
        t = t + d[3:]
    return R, t
