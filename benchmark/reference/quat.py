# Frozen copy of the port's surikatoko_tpu_torch/geom/quat.py (plain PyTorch), imports
# made local: part of the benchmark's reference, which imports nothing of the port.
"""Quaternion ops, scalar-first convention q = [w, x, y, z].

Port of ``surikatoko_tpu/geom/quat.py``. Branch-free (torch.where on both
sides, never a Python ``if`` on values) so ``torch.func.jacfwd``/``vmap``
trace them and no call waits for the card.
"""

from __future__ import annotations

import torch

_SMALL = 1e-12


def mult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a (x) b (both scalar-first [w,x,y,z])."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.as_tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                               device=q.device)


def inv(q: torch.Tensor) -> torch.Tensor:
    return conj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def from_axis_angle(w: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for rotation vector ``w`` (angle = |w|).

    Taylor-safe at |w| -> 0:  sin(theta/2)/theta -> 1/2 - theta^2/48.
    """
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _SMALL**2)
    half = 0.5 * theta
    small = theta2 < 1e-8
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw[..., None], k[..., None] * w], dim=-1)


def to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a unit quaternion (inverse of
    :func:`from_axis_angle`), angle in [0, pi]. At |qv| -> 0 the branches are
    sanitized (sqrt and atan2 never see zero), so it stays differentiable at
    the identity."""
    qw = q[..., 0]
    qv = q[..., 1:]
    sign = torch.where(qw < 0, -1.0, 1.0).to(q.dtype)
    qw = qw * sign
    qv = qv * sign[..., None]
    s2 = torch.sum(qv * qv, dim=-1)
    small = s2 < 1e-12
    s2_safe = torch.where(small, 1.0, s2)
    sin_half = torch.sqrt(s2_safe)
    half = torch.atan2(sin_half, qw)
    k_large = 2.0 * half / sin_half
    # theta = 2 atan(|qv|/qw): w = qv (2/qw) (1 - |qv|^2/(3 qw^2)) + O(th^5)
    qw_safe = torch.clamp(qw, min=1e-12)
    k_small = (2.0 / qw_safe) * (1.0 - s2 / (3.0 * qw_safe * qw_safe))
    k = torch.where(small, k_small, k_large)
    return k[..., None] * qv


def to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix of unit quaternion (batched over leading dims)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Unit quaternion of a rotation matrix (Shepperd): all four candidates
    are formed and the best-conditioned one (largest of trace, m00, m11,
    m22) is taken with a gather, no control flow."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe(x):
        return torch.sqrt(torch.clamp(x, min=1e-24))

    s0 = safe(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = safe(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = safe(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = safe(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)
    best = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)                  # [..., 4, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return normalize(torch.take_along_dim(qs, idx, dim=-2)[..., 0, :])


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by unit quaternion q (q v q*)."""
    qv = q[..., 1:]
    qw = q[..., 0:1]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)
