# Frozen copy of the port's surikatoko_tpu_torch/models/monoslam/landmarks.py (plain PyTorch), imports
# made local: part of the benchmark's reference, which imports nothing of the port.
"""Landmark lifecycle: inverse-depth state, its covariance, slot add and
remove.

Port of ``surikatoko_tpu/models/monoslam/landmarks.py`` (reference
GetNewSphericalSalientPointState :2398 (A.58), GetNewSphericalSalientPoint-
Covar :2457 (A.67-A.79), AddSalientPoint :2597, RemoveSalientPointsState
:696). The Jacobians of the initialization function are closed form
(:func:`new_landmark_jacobians`, held to ``torch.func.jacfwd`` in the
tests), batched over candidates, so adding landmarks every frame costs a
fixed handful of launches, in the host-driven filter and in the fused
recruit step alike (``fused_step.recruit_rows``).
"""

from __future__ import annotations

import torch

from . import camera as cam_mod
from . import quat
from .state import (
    CAM_STATE_COMPS,
    REPRES_XYZ,
    MonoSlamParams,
    MonoSlamState,
)

_N = CAM_STATE_COMPS


def new_landmark_state(params: MonoSlamParams, cam_pq7: torch.Tensor,
                       pix: torch.Tensor, inv_dist: torch.Tensor
                       ) -> torch.Tensor:
    """Landmark slot from its first observation (A.58): backproject the
    pixel and rotate into the tracker frame. Spherical: [first_cam_pos,
    theta, phi, rho]; XYZ: the point at distance 1/rho along the ray,
    zero-padded to 6."""
    r = cam_pq7[0:3]
    dist = params.dist if params.enable_distortion else None
    hc = cam_mod.backproject_pixel(params.cam, dist, pix)
    hw = quat.to_rotmat(cam_pq7[3:7]) @ hc
    if params.sal_pnt_repres == REPRES_XYZ:
        pos = r + hw / torch.linalg.norm(hw) / inv_dist
        return torch.cat([pos, torch.zeros_like(pos)])
    theta, phi = cam_mod.azim_elev_from_dir(hw)
    return torch.cat([r, torch.stack([theta, phi, inv_dist])])


def new_landmark_jacobians(params: MonoSlamParams, cam_pq7: torch.Tensor,
                           pix: torch.Tensor, inv_dist: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """:func:`new_landmark_state` of M candidates and its Jacobians, closed
    form: (y [M,6], J_cam [M,6,7], J_pix [M,6,2], J_rho [M,6]) for pixels
    [M,2] and inverse distances [M] seen from one camera (r, q)."""
    from .measure import _drotmat_dq
    dtype, dev = cam_pq7.dtype, cam_pq7.device
    M = pix.shape[0]
    cam = params.cam
    f = cam.focal_length_pix
    r, q = cam_pq7[0:3], cam_pq7[3:7]
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    if params.enable_distortion:
        k1, k2 = params.dist.k1, params.dist.k2
        c = pix - cam.principal_point
        d_mm = c * cam.pixel_size_mm
        rd = torch.sqrt(torch.sum(d_mm * d_mm, dim=-1) + 1e-24)
        stretch = 1.0 + k1 * rd**2 + k2 * rd**4
        dstretch = ((2.0 * k1 * rd + 4.0 * k2 * rd**3)[:, None]
                    * d_mm * cam.pixel_size_mm / rd[:, None])
        dhu = stretch[:, None, None] * eye2 + c[:, :, None] * dstretch[:, None, :]
    else:
        dhu = eye2.expand(M, 2, 2)
    hc = cam_mod.backproject_pixel(
        cam, params.dist if params.enable_distortion else None, pix)
    dhc_dpix = torch.cat([-dhu / f[None, :, None],
                          torch.zeros((M, 1, 2), dtype=dtype, device=dev)], 1)
    R = quat.to_rotmat(q)
    hw = hc @ R.T                                                   # [M,3]
    dhw_dq = torch.einsum("aij,mj->mia", _drotmat_dq(q), hc)        # [M,3,4]
    dhw_dpix = R @ dhc_dpix                                         # [M,3,2]
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(M, 3, 3)
    Jc = torch.zeros((M, 6, 7), dtype=dtype, device=dev)
    Jp = torch.zeros((M, 6, 2), dtype=dtype, device=dev)
    Jr = torch.zeros((M, 6), dtype=dtype, device=dev)
    Jc[:, 0:3, 0:3] = eye3
    if params.sal_pnt_repres == REPRES_XYZ:
        nrm = torch.linalg.norm(hw, dim=-1)
        m = hw / nrm[:, None]
        dm = (eye3 - m[:, :, None] * m[:, None, :]) / nrm[:, None, None]
        inv = (1.0 / inv_dist)[:, None, None]
        y = torch.cat([r + m / inv_dist[:, None], torch.zeros_like(m)], -1)
        Jc[:, 0:3, 3:7] = dm @ dhw_dq * inv
        Jp[:, 0:3, :] = dm @ dhw_dpix * inv
        Jr[:, 0:3] = -m / (inv_dist**2)[:, None]
        return y, Jc, Jp, Jr
    x_, y_, z_ = hw[:, 0], hw[:, 1], hw[:, 2]
    theta, phi = cam_mod.azim_elev_from_dir(hw)
    r2 = x_ * x_ + z_ * z_
    s = torch.sqrt(r2)
    n2 = r2 + y_ * y_
    zero = torch.zeros_like(x_)
    dg = torch.stack([torch.stack([z_ / r2, zero, -x_ / r2], -1),
                      torch.stack([x_ * y_ / (s * n2), -s / n2,
                                   z_ * y_ / (s * n2)], -1)], 1)    # [M,2,3]
    y = torch.cat([r.expand(M, 3), torch.stack([theta, phi, inv_dist], -1)], -1)
    Jc[:, 3:5, 3:7] = dg @ dhw_dq
    Jp[:, 3:5, :] = dg @ dhw_dpix
    Jr[:, 5] = 1.0
    return y, Jc, Jp, Jr


def _auto_covariance(params: MonoSlamParams, JcP77: torch.Tensor,
                     Jc: torch.Tensor, Jp: torch.Tensor, Jr: torch.Tensor,
                     inv_dist_std: torch.Tensor) -> torch.Tensor:
    """[M,6,6] J_cam P77 J_cam^T + R J_pix J_pix^T + sigma_rho^2 J_rho
    J_rho^T, symmetrized so the slot's block is exactly symmetric."""
    dtype = Jc.dtype
    auto = (JcP77 @ Jc.transpose(1, 2)
            + params.measurm_noise_var.to(dtype) * (Jp @ Jp.transpose(1, 2))
            + (inv_dist_std.to(dtype) ** 2) * (Jr[:, :, None] * Jr[:, None, :]))
    return 0.5 * (auto + auto.transpose(1, 2))


def new_landmark_covariance(params: MonoSlamParams, x: torch.Tensor,
                            P: torch.Tensor, pix: torch.Tensor,
                            inv_dist: torch.Tensor, inv_dist_std: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [6], autocovar [6,6], cross-covar with all D vars [6,D]) by
    first-order propagation (A.67-A.79); the autocovariance is symmetrized
    (JAX leaves its rounding asymmetry)."""
    y, Jc, Jp, Jr = new_landmark_jacobians(params, x[:7], pix[None],
                                           inv_dist.reshape(1))
    auto = _auto_covariance(params, Jc @ P[:7, :7], Jc, Jp, Jr, inv_dist_std)
    return y[0], auto[0], Jc[0] @ P[:7, :]


def add_landmarks(params: MonoSlamParams, state: MonoSlamState,
                  new_pix: torch.Tensor, new_mask: torch.Tensor,
                  gt_inv_dist: torch.Tensor | None = None
                  ) -> tuple[MonoSlamState, torch.Tensor]:
    """Claim the first free slot for each valid candidate in order (the
    host-driven filter calls this every frame; the runners' bootstraps
    once). Returns (state, slot ids [M] int32, -1 where not added).

    JAX scans the M candidates one by one. Each new slot's rows are the
    camera rows' first-order propagation J_cam P[:7, :], and its couplings
    to an earlier new slot of the same call are J_m P77 J_n^T, so all M are
    formed in one batch (``fused_step.recruit_rows`` without a predict):
    the result is JAX's to rounding, exactly symmetric. No value is read on
    the host."""
    from .fused_step import (
        _write_sym_stripes, recruit_rows, scatter_drop)
    Kcap = state.capacity
    dtype, dev = state.x.dtype, state.x.device
    M = new_pix.shape[0]
    if M == 0:
        return state, torch.zeros(0, dtype=torch.int32, device=dev)
    rho0 = params.sal_pnt_init_inv_dist.to(dtype)
    rho = (None if gt_inv_dist is None else
           torch.where(torch.isnan(gt_inv_dist), rho0, gt_inv_dist.to(dtype)))
    y, rows, slots, valid, idx, idx_safe, v6 = recruit_rows(
        params, state.x[:7], state.P[:7, :], state.P[:7, :7], ~state.lm_active,
        new_pix, new_mask, rho)
    P = state.P.clone()
    _write_sym_stripes(P, idx, v6, rows)
    x = scatter_drop(state.x, idx_safe, y.reshape(6 * M))
    claimed = scatter_drop(torch.zeros_like(state.lm_active),
                           torch.where(valid, slots, Kcap).long(),
                           torch.ones_like(valid))
    return state._replace(
        x=x, P=P, lm_active=state.lm_active | claimed,
        lm_unobserved=torch.where(claimed, 0, state.lm_unobserved),
        lm_generation=state.lm_generation + claimed.to(torch.int32)), slots


def remove_landmarks(state: MonoSlamState, remove_mask: torch.Tensor
                     ) -> MonoSlamState:
    """Deactivate slots: zero their state and their covariance rows and
    columns. Removal only deletes information, so symmetry (exact: the
    mask multiplies both halves alike) and PSD of the rest are kept."""
    keep = ~(remove_mask & state.lm_active)
    var_keep = torch.cat([
        torch.ones(_N, dtype=torch.bool, device=keep.device),
        torch.repeat_interleave(keep, 6)]).to(state.x.dtype)
    return state._replace(x=state.x * var_keep,
                          P=state.P * var_keep[:, None] * var_keep[None, :],
                          lm_active=state.lm_active & keep)
