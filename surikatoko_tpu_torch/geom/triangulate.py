"""Triangulation and P-matrix decomposition.

Port of ``surikatoko_tpu/geom/triangulate.py`` (reference obs-geom.cpp:606-677
``DecomposeProjMat`` and :679-727 ``Triangulate3DPointByLeastSquares``). The
triangulator is masked and batched: a fixed number of frame slots per point
with a validity mask, so thousands of tracks triangulate as one batched 3x3
normal-equation solve.

Projection convention (Kanatani's f0-scaled form, used by the BA stack and
the dino dataset):  [u, v, f0]^T ∝ P @ [X, 1]^T.
"""

from __future__ import annotations

import torch

from surikatoko_tpu_torch.geom.se3 import SE3


def triangulate_point_least_squares(
    proj_mats: torch.Tensor,            # [F, 3, 4]
    xs2d: torch.Tensor,                 # [..., F, 2]
    f0: torch.Tensor | float = 1.0,
    mask: torch.Tensor | None = None,   # [..., F] bool; at least 2 true
) -> torch.Tensor:
    """Inhomogeneous DLT: rows x*P3 - f0*P1 and y*P3 - f0*P2 (reference :689),
    solved through the 3x3 normal equations (masked rows contribute zero).
    Leading dims of ``xs2d`` and ``mask`` are a batch of points: [..., 3]."""
    x = xs2d[..., 0:1]
    y = xs2d[..., 1:2]
    P1, P2, P3 = proj_mats[..., 0, :], proj_mats[..., 1, :], proj_mats[..., 2, :]
    f0 = torch.as_tensor(f0, dtype=proj_mats.dtype, device=proj_mats.device)
    rows = torch.stack([x * P3 - f0 * P1, y * P3 - f0 * P2], dim=-2)  # [..,F,2,4]
    if mask is not None:
        rows = rows * mask[..., None, None].to(rows.dtype)
    A = rows[..., :3].flatten(-3, -2)                    # [..., 2F, 3]
    B = -rows[..., 3].flatten(-2, -1)                    # [..., 2F]
    AtA = A.mT @ A
    AtB = (A.mT @ B[..., None])[..., 0]
    # tiny Tikhonov keeps the solve defined for degenerate/masked-out tracks
    eye = torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    return torch.linalg.solve(AtA + 1e-12 * eye, AtB)


def triangulate_points_batch(proj_mats, xs2d, f0, mask) -> torch.Tensor:
    """proj_mats [F,3,4], xs2d [N,F,2], f0, mask [N,F] -> [N,3] (the JAX
    package's vmap over points)."""
    return triangulate_point_least_squares(proj_mats, xs2d, f0, mask)


def decompose_proj_mat(P: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, SE3]:
    """P[3,4] -> (scale, K upper-triangular with K[2,2]=1, wfc SE3).

    Satisfies  P ≈ scale * K * R^T * [I | -t]  with R in SO(3) (so the SE3
    returned maps camera->world: columns of R are camera axes, t the center).
    Mirrors the Cholesky route of reference obs-geom.cpp:606-677.
    """
    Q = P[:, :3]
    q = P[:, 3]
    det = torch.linalg.det(Q)
    sign = torch.where(det < 0, -1.0, 1.0).to(P.dtype)
    Q = Q * sign
    q = q * sign

    t = -torch.linalg.solve(Q, q)

    QQt_inv = torch.linalg.inv(Q @ Q.T)
    C = torch.linalg.cholesky(QQt_inv).T  # upper triangular
    R = (C @ Q).T

    C_inv = torch.linalg.inv(C)
    c_last = C_inv[2, 2]
    K = C_inv / c_last
    scale = sign * c_last
    return scale, K, SE3(R, t)
