"""Quaternion ops, scalar-first convention q = [w, x, y, z].

Port of ``surikatoko_tpu/geom/quat.py`` (the slice's subset). Branch-free
(torch.where on both sides) so ``torch.func.jacfwd``/``vmap`` trace them.
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
