"""Rotations, the pinhole projection and the reprojection cost.

A pose is camera-from-world (R, t): a world point X sits at R X + t in the
camera, whose centre is -R^T t. A pixel is K applied to the camera point
over its depth (K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]); a normalized
coordinate is the camera point over its depth."""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3], skew(a) b = a x b."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """The rotation by angle |w| about w/|w| ([..., 3] -> [..., 3, 3])."""
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    small = th < 1e-6
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th * th / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th * th / 24.0,
                    (1.0 - torch.cos(ths)) / (ths * ths))
    S = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * S + b * (S @ S)


def rotation_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """The angle of Ra Rb^T, from |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2)
    (exact for small angles, where the trace's arccos is not)."""
    d = torch.linalg.norm((Ra - Rb).flatten(-2), dim=-1)
    return 2.0 * torch.asin(torch.clamp(d / (2.0 * 2.0 ** 0.5), max=1.0))


def centres(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera centres -R^-1 t ([..., 3]): R^T t for a rotation, and exact
    for a rotation rounded to a lower precision too."""
    return -torch.linalg.solve(R, t[..., None])[..., 0]


def to_camera(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return (R @ X[..., None])[..., 0] + t


def project(K: torch.Tensor, R, t, X) -> torch.Tensor:
    """Pixels [..., 2] of world points X under poses (R, t); K is
    (fx, fy, cx, cy)."""
    xc = to_camera(R, t, X)
    return torch.stack([K[0] * xc[..., 0] / xc[..., 2] + K[2],
                        K[1] * xc[..., 1] / xc[..., 2] + K[3]], -1)


def normalized(K: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Normalized coordinates [..., 2] of pixels."""
    return torch.stack([(pix[..., 0] - K[2]) / K[0],
                        (pix[..., 1] - K[3]) / K[1]], -1)


def reprojection_cost(K, R, t, X, pt, cam, pix) -> torch.Tensor:
    """Sum over observations (point ``pt[o]`` in camera ``cam[o]`` at
    ``pix[o]``) of the squared pixel error."""
    r = project(K, R[cam], t[cam], X[pt]) - pix
    return torch.sum(r * r)
