# Frozen copy of the port's surikatoko_tpu_torch/models/monoslam/measure.py (plain PyTorch), imports
# made local: part of the benchmark's reference, which imports nothing of the port.
"""Measurement model h(x): project every landmark slot into the current
camera, with closed-form Jacobian blocks.

Port of ``surikatoko_tpu/models/monoslam/measure.py`` (reference
davison-mono-slam.cpp:2880-3360). H is block-sparse, so it is returned as
per-slot blocks Hcam [K,2,13] and Hlm [K,2,6]; ``project_landmark`` is the
forward model the tests differentiate with ``torch.func.jacfwd`` as the
oracle of :func:`measurement_jacobians`.
"""

from __future__ import annotations

import torch

from . import camera as cam_mod
from . import quat
from .state import (
    CAM_STATE_COMPS,
    REPRES_SPHERICAL,
    REPRES_XYZ,
    MonoSlamParams,
)


def landmark_camera_point_scaled(cam13: torch.Tensor, lm6: torch.Tensor,
                                 repres: int) -> torch.Tensor:
    """Landmark in the camera frame, scaled by rho for the spherical
    representation (reference InternalSalientPointToCamera :2880-2940)."""
    r = cam13[0:3]
    R_wfc = quat.to_rotmat(cam13[3:7])
    if repres == REPRES_XYZ:
        v_world = lm6[0:3] - r
    else:
        m = cam_mod.dir_from_azim_elev(lm6[3], lm6[4])
        v_world = lm6[5] * (lm6[0:3] - r) + m
    return R_wfc.T @ v_world


def project_landmark(params: MonoSlamParams, cam13: torch.Tensor,
                     lm6: torch.Tensor) -> torch.Tensor:
    """Distorted pixel of one landmark (reference :2948)."""
    hc = landmark_camera_point_scaled(cam13, lm6, params.sal_pnt_repres)
    dist = params.dist if params.enable_distortion else None
    return cam_mod.project_camera_point(params.cam, dist, hc)


def landmark_world_pos(lm6: torch.Tensor,
                       substitute_rho: torch.Tensor | None = None,
                       repres: int = REPRES_SPHERICAL) -> torch.Tensor:
    """Euclidean position of landmark slots [..., 6] -> [..., 3] (reference
    ConvertXyzFromSphericalSalientPoint :405-415; identity for XYZ). A rho
    <= 0 is replaced by ``substitute_rho`` where one is given."""
    if repres == REPRES_XYZ:
        return lm6[..., 0:3]
    rho = lm6[..., 5]
    if substitute_rho is not None:
        rho = torch.where(rho <= 0, substitute_rho.to(lm6.dtype), rho)
    m = cam_mod.dir_from_azim_elev(lm6[..., 3], lm6[..., 4])
    return lm6[..., 0:3] + m / rho[..., None]


def spherical_to_xyz_slot(lm6: torch.Tensor) -> torch.Tensor:
    """Spherical slot -> XYZ slot (position, zero padded; reference
    :405-415)."""
    pos = landmark_world_pos(lm6)
    return torch.cat([pos, torch.zeros_like(pos)], dim=-1)


def xyz_to_spherical_slot(lm6: torch.Tensor, first_cam_pos: torch.Tensor
                          ) -> torch.Tensor:
    """XYZ slot -> spherical slot anchored at ``first_cam_pos`` (reference
    :417-467)."""
    d = lm6[..., 0:3] - first_cam_pos
    theta, phi = cam_mod.azim_elev_from_dir(d)
    rho = 1.0 / torch.linalg.norm(d, dim=-1)
    return torch.cat([first_cam_pos.expand_as(d),
                      torch.stack([theta, phi, rho], dim=-1)], dim=-1)


def project_all(params: MonoSlamParams, x: torch.Tensor) -> torch.Tensor:
    """Predicted pixels of every slot: [..., K, 2] for states x [..., D]
    (a leading batch of states takes the place of JAX's vmap)."""
    cam13 = x[..., :CAM_STATE_COMPS]
    lms = x[..., CAM_STATE_COMPS:].reshape(x.shape[:-1] + (-1, 6))
    r = cam13[..., None, 0:3]
    if params.sal_pnt_repres == REPRES_XYZ:
        v = lms[..., 0:3] - r
    else:
        m = cam_mod.dir_from_azim_elev(lms[..., 3], lms[..., 4])
        v = lms[..., 5:6] * (lms[..., 0:3] - r) + m
    y = v @ quat.to_rotmat(cam13[..., 3:7])       # rows R_wfc^T v
    dist = params.dist if params.enable_distortion else None
    return cam_mod.project_camera_point(params.cam, dist, y)


def _drotmat_dq(q: torch.Tensor) -> torch.Tensor:
    """d(to_rotmat)/dq as [4,3,3]."""
    w, xq, y, z = q[0], q[1], q[2], q[3]
    o = torch.zeros((), dtype=q.dtype, device=q.device)
    dw = 2.0 * torch.stack([o, -z, y, z, o, -xq, -y, xq, o]).reshape(3, 3)
    dx = 2.0 * torch.stack([o, y, z, y, -2 * xq, -w, z, w, -2 * xq]).reshape(3, 3)
    dy = 2.0 * torch.stack([-2 * y, xq, w, xq, o, z, -w, z, -2 * y]).reshape(3, 3)
    dz = 2.0 * torch.stack([-2 * z, -w, xq, w, -2 * z, y, xq, y, o]).reshape(3, 3)
    return torch.stack([dw, dx, dy, dz])


def _dproj_dy(params: MonoSlamParams, y: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pix [K,2], d pix / d y_cam [K,2,3]) for camera-frame points y."""
    cam = params.cam
    f = cam.focal_length_pix
    z = y[:, 2]
    inv_z = 1.0 / z
    hu = cam.principal_point - f * y[:, :2] / z[:, None]
    zero = torch.zeros_like(z)
    Jx = torch.stack([-f[0] * inv_z, zero, f[0] * y[:, 0] * inv_z * inv_z], -1)
    Jy = torch.stack([zero, -f[1] * inv_z, f[1] * y[:, 1] * inv_z * inv_z], -1)
    J_hu = torch.stack([Jx, Jy], dim=1)
    if not params.enable_distortion:
        return hu, J_hu

    k1, k2 = params.dist.k1, params.dist.k2
    p = hu - cam.principal_point
    d_mm = p * cam.pixel_size_mm
    ru = torch.sqrt(torch.sum(d_mm * d_mm, dim=-1) + 1e-24)
    rd = cam_mod.solve_distorted_radius(ru, k1, k2)
    gp = 1.0 + 3.0 * k1 * rd**2 + 5.0 * k2 * rd**4
    stretch = 1.0 + k1 * rd**2 + k2 * rd**4
    hd = cam.principal_point + p / stretch[:, None]
    dstretch_drd = 2.0 * k1 * rd + 4.0 * k2 * rd**3
    dru_dhu = d_mm * cam.pixel_size_mm / ru[:, None]
    dinv_dhu = (-dstretch_drd / (gp * stretch * stretch))[:, None] * dru_dhu
    eye2 = torch.eye(2, dtype=y.dtype, device=y.device)
    J_hd = eye2 / stretch[:, None, None] + p[:, :, None] * dinv_dhu[:, None, :]
    return hd, torch.einsum("kij,kjl->kil", J_hd, J_hu)


def batched_jacobians(params: MonoSlamParams, cam13: torch.Tensor,
                      lms: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h [K,2], Hcam [K,2,13], Hlm [K,2,6]) for landmark slots ``lms``:
    the analytic [K]-batched chain rule (reference :3067-3360)."""
    K = lms.shape[0]
    r = cam13[0:3]
    q = cam13[3:7]
    R = quat.to_rotmat(q)
    Dq = _drotmat_dq(q)
    if params.sal_pnt_repres == REPRES_XYZ:
        v = lms[:, 0:3] - r
    else:
        c0 = lms[:, 0:3]
        theta, phi, rho = lms[:, 3], lms[:, 4], lms[:, 5]
        st, ct = torch.sin(theta), torch.cos(theta)
        sp, cp = torch.sin(phi), torch.cos(phi)
        m = torch.stack([cp * st, -sp, cp * ct], dim=-1)
        dm_dtheta = torch.stack([cp * ct, torch.zeros_like(cp), -cp * st], -1)
        dm_dphi = torch.stack([-sp * st, -cp, -sp * ct], dim=-1)
        diff = c0 - r
        v = rho[:, None] * diff + m

    y = v @ R
    h, J = _dproj_dy(params, y)
    JR = J @ R.T
    dy_dq = torch.einsum("aij,ki->kja", Dq, v)
    Hq = torch.einsum("kij,kja->kia", J, dy_dq)
    zeros3 = torch.zeros((K, 2, 3), dtype=cam13.dtype, device=cam13.device)
    if params.sal_pnt_repres == REPRES_XYZ:
        Hr = -JR
        Hlm = torch.cat([JR, zeros3], dim=-1)
    else:
        Hr = -rho[:, None, None] * JR
        Hc0 = rho[:, None, None] * JR
        Hth = torch.einsum("kij,kj->ki", JR, dm_dtheta)[:, :, None]
        Hph = torch.einsum("kij,kj->ki", JR, dm_dphi)[:, :, None]
        Hrho = torch.einsum("kij,kj->ki", JR, diff)[:, :, None]
        Hlm = torch.cat([Hc0, Hth, Hph, Hrho], dim=-1)
    Hcam = torch.cat([Hr, Hq, zeros3, zeros3], dim=-1)
    return h, Hcam, Hlm


def measurement_jacobians(params: MonoSlamParams, x: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h [K,2], Hcam [K,2,13], Hlm [K,2,6]) for all slots of state ``x``."""
    return batched_jacobians(params, x[:CAM_STATE_COMPS],
                             x[CAM_STATE_COMPS:].reshape(-1, 6))
