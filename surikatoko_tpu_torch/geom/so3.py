"""SO(3) utilities: skew, exp (Rodrigues), log, rotation about an axis and
the projection back onto SO(3).

Port of ``surikatoko_tpu/geom/so3.py`` (reference obs-geom.cpp:512-604,
lin-alg.cpp:6-27).
"""

from __future__ import annotations

import torch


def skew(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x with [w]_x v = w × v."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1
    ).reshape(w.shape[:-1] + (3, 3))


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation matrix for rotation vector w (angle = |w|).

    Differentiable at w=0, the linearization point of every BA Jacobian:
    theta2 is sanitized *before* the sqrt, so under ``torch.func.jacfwd``
    the unused ``torch.where`` branch carries no NaN tangent into the
    frame Jacobians.
    """
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, 1.0, theta2)   # sanitized for BOTH primal
    theta = torch.sqrt(theta2_safe)                 # and tangent paths
    K = skew(w)
    K2 = K @ K
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a * K + b * K2


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of R (inverse Rodrigues) through the quaternion,
    stable at theta ~ 0 and theta ~ pi."""
    from surikatoko_tpu_torch.geom import quat
    return quat.to_axis_angle(quat.from_rotmat(R))


def rotmat_about_axis(axis: torch.Tensor, angle) -> torch.Tensor:
    """Rotation by `angle` about unit `axis` (reference RotMat(axis, ang))."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    return exp(axis * angle[..., None] if angle.ndim else axis * angle)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Nearest rotation by the polar projection U V^T (SVD), the last
    singular vector flipped where that is needed to stay in SO(3)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    fix = torch.ones(R.shape[:-2] + (3,), dtype=R.dtype, device=R.device)
    fix = torch.cat([fix[..., :2], det[..., None]], dim=-1)
    return (u * fix[..., None, :]) @ vt


def project_onto_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation to an arbitrary 3x3 M (MASKS eq. 8.41-8.44;
    reference multi-view-factorization.cpp:78)."""
    return orthonormalize(M)
