"""Points from their observations under known poses: linear (DLT)
triangulation, then Gauss-Newton on the normalized reprojection residuals;
and the two numbers by which the pipeline decides whether a track becomes
a point.

Departures from the published description:
- the residual is in normalized coordinates (as in ``pnp``);
- the keep-or-drop rule is the pipeline's, not a textbook one: a track
  becomes a point only where the two-view-summed linear depth of its first
  observation (MASKS eq. 8.44) is positive and the spread of its observing
  camera centres over that depth (twice the largest distance from their
  mean) is at least a given ratio. Which tracks become points is part of
  the pipeline's result, so the reference takes the same rule.

Every function works on a batch of tracks: N tracks of at most M
observations, ``mask`` [N, M] marking the real ones (the first real one is
the track's first observation)."""

from __future__ import annotations

import torch

from .geometry import centres, skew

ITERS = 20          # from the DLT estimate: converged long before


def dlt(R: torch.Tensor, t: torch.Tensor, x: torch.Tensor,
        mask: torch.Tensor) -> torch.Tensor:
    """[N, 3] points by the homogeneous linear system x P3 - P1, y P3 - P2
    of every observation (P = [R | t], x [N, M, 2] normalized), its
    smallest right singular vector."""
    P = torch.cat([R, t[..., None]], dim=-1)                 # [N, M, 3, 4]
    rows = torch.stack([x[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                        x[..., 1:2] * P[..., 2, :] - P[..., 1, :]], dim=-2)
    rows = rows * mask[..., None, None].to(R.dtype)
    A = rows.reshape(R.shape[0], -1, 4)
    h = torch.linalg.svd(A, full_matrices=False)[2][:, -1]
    return h[:, :3] / h[:, 3:4]


def refine(X: torch.Tensor, R, t, x, mask, iters: int = ITERS) -> torch.Tensor:
    """Gauss-Newton on sum |x(R X + t) - x_obs|^2 over each track's
    observations, from X [N, 3]."""
    m = mask.to(X.dtype)[..., None, None]
    for _ in range(iters):
        xc = (R @ X[:, None, :, None])[..., 0] + t            # [N, M, 3]
        z = xc[..., 2]
        r = (xc[..., :2] / z[..., None] - x)[..., None] * m   # [N, M, 2, 1]
        dproj = torch.zeros(xc.shape[:2] + (2, 3), dtype=X.dtype,
                            device=X.device)
        dproj[..., 0, 0] = 1.0 / z
        dproj[..., 1, 1] = 1.0 / z
        dproj[..., 0, 2] = -xc[..., 0] / (z * z)
        dproj[..., 1, 2] = -xc[..., 1] / (z * z)
        J = dproj @ R * m                                     # [N, M, 2, 3]
        H = torch.einsum("nmia,nmib->nab", J, J)
        g = torch.einsum("nmia,nmi->na", J, r[..., 0])
        X = X + torch.linalg.solve(H, -g)
    return X


def first_view_depth(R, t, x, mask) -> torch.Tensor:
    """[N] depth of each track's point in its first observation's camera,
    from all the others (MASKS eq. 8.44): alpha = -sum <x_i^ T_i, x_i^ R_i
    x_1> / sum |x_i^ T_i|^2 with (R_i, T_i) camera i from camera 1, and
    depth = 1 / alpha (inf where alpha is 0)."""
    R1, t1 = R[:, 0], t[:, 0]
    R_i1 = R[:, 1:] @ R1.transpose(-1, -2)[:, None]
    T_i1 = t[:, 1:] - (R_i1 @ t1[:, None, :, None])[..., 0]
    ones = torch.ones_like(x[..., :1])
    xh = torch.cat([x, ones], dim=-1)
    S = skew(xh[:, 1:])
    a = (S @ T_i1[..., None])[..., 0]
    b = (S @ (R_i1 @ xh[:, 0, None, :, None]))[..., 0]
    m = mask[:, 1:].to(R.dtype)
    num = torch.sum(torch.sum(a * b, -1) * m, -1)
    den = torch.sum(torch.sum(a * a, -1) * m, -1)
    alpha = -num / torch.where(den == 0, torch.ones_like(den), den)
    return 1.0 / alpha


def parallax_ratio(R, t, mask, depth) -> torch.Tensor:
    """[N] twice the largest distance of the observing camera centres from
    their mean, over ``depth``."""
    c = centres(R, t)
    m = mask.to(R.dtype)[..., None]
    mean = torch.sum(c * m, 1) / torch.sum(m, 1)
    spread = torch.sqrt(torch.amax(torch.sum((c - mean[:, None]) ** 2, -1)
                                   * m[..., 0], dim=1))
    return 2.0 * spread / depth
