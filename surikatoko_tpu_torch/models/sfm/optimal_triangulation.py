"""Optimal two-view correspondence correction (Hartley-Sturm, HZ alg. 12.1).

Port of ``surikatoko_tpu/models/sfm/optimal_triangulation.py`` (capability
match for the reference prototype's "poly6" correction, py_proto/suriko/
mvg.py:2558-2728): given F and a correspondence (x1, x2), the pair (x1',
x2') exactly on the epipolar constraint nearest in geometric distance. As
in the JAX package, the epipolar pencil's cost s(t) is minimized directly
(a dense scan over t = tan(theta), then Newton steps that are kept only
where they lower the cost) rather than through the degree-6 roots, for all
correspondences as one batch.
"""

from __future__ import annotations

import math

import torch
from torch.func import grad, vmap


def _transforms(F, x1, x2):
    """Translate the points to the origin and rotate the epipoles onto the
    x-axis (HZ 12.1 steps i-iv), per correspondence: x [N, 2] -> F' [N,3,3]
    and the rigid transforms."""
    N = x1.shape[0]
    eye = torch.eye(3, dtype=F.dtype, device=F.device).expand(N, 3, 3)

    def trans(p):
        T = eye.clone()
        T[:, 0, 2] = -p[:, 0]
        T[:, 1, 2] = -p[:, 1]
        return T

    T1, T2 = trans(x1), trans(x2)
    Fs = torch.linalg.inv(T2).transpose(-1, -2) @ F @ torch.linalg.inv(T1)

    # epipoles: F e1 = 0, F^T e2 = 0; normalized to e_x^2 + e_y^2 = 1
    U, _, Vt = torch.linalg.svd(Fs)
    e1 = Vt[:, -1, :]
    e2 = U[:, :, -1]

    def normi(e):
        s = torch.sqrt(e[:, 0] ** 2 + e[:, 1] ** 2)
        return e / torch.where(s < 1e-15, 1.0, s)[:, None]

    e1, e2 = normi(e1), normi(e2)

    def rot(e):
        R = eye.clone()
        R[:, 0, 0], R[:, 0, 1] = e[:, 0], e[:, 1]
        R[:, 1, 0], R[:, 1, 1] = -e[:, 1], e[:, 0]
        return R

    R1, R2 = rot(e1), rot(e2)
    Fr = R2 @ Fs @ R1.transpose(-1, -2)
    return Fr, T1, T2, R1, R2, e1[:, 2], e2[:, 2]


def _cost(t, f1, f2, a, b, c, d):
    """Squared geometric distance s(t) (HZ 12.5)."""
    return (t * t / (1 + f1 * f1 * t * t)
            + (c * t + d) ** 2 / ((a * t + b) ** 2 + f2 * f2 * (c * t + d) ** 2))


_dcost = grad(_cost)
_ddcost = grad(_dcost)


def correct_correspondences_batch(F: torch.Tensor, x1: torch.Tensor,
                                  x2: torch.Tensor, n_samples: int = 256,
                                  newton_iters: int = 4
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal (x1', x2') [N, 2] each with x2'^T F x1' = 0 minimizing
    |x1-x1'|^2 + |x2-x2'|^2, for correspondences x1, x2 [N, 2]."""
    dtype, dev = F.dtype, F.device
    Fr, T1, T2, R1, R2, f1, f2 = _transforms(F, x1, x2)
    a, b, c, d = Fr[:, 1, 1], Fr[:, 1, 2], Fr[:, 2, 1], Fr[:, 2, 2]
    coef = (f1, f2, a, b, c, d)

    # global scan over t = tan(theta) on a theta grid, then Newton polish
    theta = torch.linspace(-math.pi / 2 + 1e-3, math.pi / 2 - 1e-3, n_samples,
                           dtype=dtype, device=dev)
    ts = torch.tan(theta)
    costs = _cost(ts[None, :], *(v[:, None] for v in coef))     # [N, S]
    t = ts[torch.argmin(costs, dim=1)]

    g = vmap(_dcost)
    h = vmap(_ddcost)
    for _ in range(newton_iters):
        dg, ddg = g(t, *coef), h(t, *coef)
        step = dg / torch.where(torch.abs(ddg) < 1e-18, 1e-18, ddg)
        t_new = t - torch.clamp(step, -1e3, 1e3)
        better = _cost(t_new, *coef) < _cost(t, *coef)
        t = torch.where(better, t_new, t)
    # also consider t -> inf (the epipolar line at infinity, HZ's note)
    cost_inf = 1.0 / (f1 * f1) + c * c / (a * a + f2 * f2 * c * c)
    use_inf = cost_inf < _cost(t, *coef)

    # closest points on the epipolar lines l1 = (t f1, 1, -t), l2 = F [0,t,1]^T
    o, z = torch.ones_like(t), torch.zeros_like(t)
    l1 = torch.stack([t * f1, o, -t], dim=-1)
    l2 = (Fr @ torch.stack([z, t, o], dim=-1)[..., None])[..., 0]
    l1_inf = torch.stack([f1, z, -o], dim=-1)
    l2_inf = (Fr @ torch.stack([z, o, z], dim=-1)[..., None])[..., 0]
    l1 = torch.where(use_inf[:, None], l1_inf, l1)
    l2 = torch.where(use_inf[:, None], l2_inf, l2)

    def closest_to_origin(l):
        lx, ly, lz = l[:, 0], l[:, 1], l[:, 2]
        s = lx * lx + ly * ly
        p = torch.stack([-lx * lz, -ly * lz, s], dim=-1)
        return p / torch.where(s < 1e-30, 1.0, s)[:, None]

    # undo the transforms
    x1c = (torch.linalg.inv(T1) @ (R1.transpose(-1, -2)
                                   @ closest_to_origin(l1)[..., None]))[..., 0]
    x2c = (torch.linalg.inv(T2) @ (R2.transpose(-1, -2)
                                   @ closest_to_origin(l2)[..., None]))[..., 0]
    return x1c[:, :2] / x1c[:, 2:], x2c[:, :2] / x2c[:, 2:]


def correct_correspondence(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                           n_samples: int = 256, newton_iters: int = 4
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One correspondence x1, x2 [2]: the batch of one."""
    x1c, x2c = correct_correspondences_batch(F, x1[None], x2[None],
                                             n_samples, newton_iters)
    return x1c[0], x2c[0]
