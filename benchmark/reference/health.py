# Frozen copy of the port's surikatoko_tpu_torch/models/monoslam/health.py (plain PyTorch), imports
# made local: part of the benchmark's reference, which imports nothing of the port.
"""Filter-health mechanisms: the reference's self-healing toolbox.

Port of ``surikatoko_tpu/models/monoslam/health.py`` (reference
davison-mono-slam.cpp):
  normalize_quat_and_covar    <- NormalizeCameraOrientationQuaternionAndCovariances :1652
  ensure_nonneg_variance      <- EnsureNonnegativeStateVariance :1739
  substitute_negative_inv_rho <- :1713-1737
  symmetrize                  <- FixSymmetricMat :4308
  landmark_pos_covariances, bad_uncertainty_mask
                              <- RemoveSalientPointsWithNonextractableUncertEllipsoid :542
  reset_camera_to_gt, reset_state_to_gt
                              <- SetEstimStateAndCovarToGroundTruth :2117-2140
  check_state                 <- CheckCameraAndSalientPointsCovs :514

The Jacobians (quaternion renorm, spherical -> XYZ) are closed form and
batched over slots: the host-driven filter runs these every frame, and
``torch.func`` transforms cost host dispatch there. Nothing here reads a
value on the host.
"""

from __future__ import annotations

import torch

from . import camera as cam_mod
from .state import (
    CAM_STATE_COMPS,
    REPRES_SPHERICAL,
    REPRES_XYZ,
    MonoSlamState,
)

_N = CAM_STATE_COMPS


def normalize_quat_and_covar(x: torch.Tensor, P: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Renormalize the camera quaternion and carry the normalization's
    Jacobian J_q = (I - q^ q^T)/|q| into P <- J P J^T. Only the 4-wide
    quaternion stripe changes: the column stripe is written as the exact
    transpose of the row stripe and the 4x4 corner, where both apply, is
    symmetrized, so a symmetric P stays exactly symmetric."""
    q = x[3:7]
    qn = torch.linalg.norm(q)
    nq = q / qn
    Jq = (torch.eye(4, dtype=x.dtype, device=x.device)
          - torch.outer(nq, nq)) / qn
    x_new = torch.cat([x[:3], nq, x[7:]])
    rows = Jq @ P[3:7, :]                       # [4,D] = (J P)[3:7, :]
    corner = rows[:, 3:7] @ Jq.T
    corner = 0.5 * (corner + corner.T)
    P_new = P.clone()
    P_new[3:7, :] = rows
    P_new[:, 3:7] = rows.T
    P_new[3:7, 3:7] = corner
    return x_new, P_new


def ensure_nonneg_variance(P: torch.Tensor) -> torch.Tensor:
    """Zero the rows/cols of any state variable with negative variance."""
    keep = (~(torch.diagonal(P) < 0)).to(P.dtype)
    return P * keep[:, None] * keep[None, :]


def substitute_negative_inv_rho(x: torch.Tensor, substitute: torch.Tensor,
                                capacity: int
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Replace negative inverse depths with ``substitute``; returns
    (x', count substituted)."""
    lms = x[_N:].reshape(capacity, 6)
    neg = lms[:, 5] < 0
    rho = torch.where(neg, substitute.to(x.dtype), lms[:, 5])
    lms = torch.cat([lms[:, :5], rho[:, None]], dim=1)
    return torch.cat([x[:_N], lms.reshape(-1)]), neg.sum(dtype=torch.int32)


def symmetrize(P: torch.Tensor) -> torch.Tensor:
    return 0.5 * (P + P.T)


def landmark_pos_covariances(x: torch.Tensor, P: torch.Tensor, capacity: int,
                             substitute_rho: torch.Tensor | None,
                             repres: int = REPRES_SPHERICAL
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos [K,3], cov [K,3,3]) of each landmark's Euclidean position by
    first-order propagation through the spherical -> XYZ map (reference
    GetSalientPoint3DPosWithUncertaintyNew :3889; identity map for XYZ
    slots). The Jacobian [K,3,6] is closed form: [I, dm/dtheta / rho,
    dm/dphi / rho, -m / rho^2], with the rho column 0 where ``substitute_rho``
    replaces rho <= 0 (a constant there)."""
    from .measure import landmark_world_pos
    dtype, dev = x.dtype, x.device
    lms = x[_N:].reshape(capacity, 6)
    covs6 = torch.diagonal(P[_N:, _N:].reshape(capacity, 6, capacity, 6),
                           dim1=0, dim2=2).permute(2, 0, 1)          # [K,6,6]
    pos = landmark_world_pos(lms, substitute_rho, repres)
    J = torch.zeros((capacity, 3, 6), dtype=dtype, device=dev)
    J[:, :, 0:3] = torch.eye(3, dtype=dtype, device=dev)
    if repres != REPRES_XYZ:
        theta, phi, rho = lms[:, 3], lms[:, 4], lms[:, 5]
        if substitute_rho is None:
            subst, rho_e = torch.zeros_like(rho, dtype=torch.bool), rho
        else:
            subst = rho <= 0
            rho_e = torch.where(subst, substitute_rho.to(dtype), rho)
        st, ct = torch.sin(theta), torch.cos(theta)
        sp, cp = torch.sin(phi), torch.cos(phi)
        m = cam_mod.dir_from_azim_elev(theta, phi)
        zero = torch.zeros_like(theta)
        J[:, :, 3] = torch.stack([cp * ct, zero, -cp * st], -1) / rho_e[:, None]
        J[:, :, 4] = torch.stack([-sp * st, -cp, -sp * ct], -1) / rho_e[:, None]
        J[:, :, 5] = torch.where(subst[:, None], 0.0, -m / (rho_e**2)[:, None])
    return pos, J @ covs6 @ J.transpose(1, 2)


def bad_uncertainty_mask(x: torch.Tensor, P: torch.Tensor, capacity: int,
                         substitute_rho: torch.Tensor,
                         repres: int = REPRES_SPHERICAL) -> torch.Tensor:
    """True for landmarks whose 3D uncertainty ellipsoid cannot be
    extracted (propagated covariance not finite or not positive definite):
    candidates for removal.

    Positive definiteness by Sylvester's criterion, evaluated as the three
    pivots of the 3x3 Cholesky factorization (det_k / det_{k-1}), which is
    the same test in exact arithmetic. JAX forms the minors themselves, and
    for an elongated covariance (a landmark whose rho was substituted: entries
    ~1e12 around eigenvalues ~1e2) the determinant cancels to rounding, so
    its sign there is rounding's and two devices disagree; the pivots keep
    the small eigenvalues (error ~eps |C|). Wherever JAX's minors are well
    conditioned the two agree."""
    _, covs = landmark_pos_covariances(x, P, capacity, substitute_rho, repres)
    a, b, c = covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2]
    d, e, f = covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]
    p2 = d - b * b / a
    l32 = e - b * c / a
    p3 = f - c * c / a - l32 * l32 / p2
    finite = torch.isfinite(covs.reshape(capacity, -1)).all(dim=-1)
    pd = (a > 0) & (p2 > 0) & (p3 > 0)
    return ~(finite & pd)


def _cam_diag(pos_std, q_std, vel_std, ang_std, dtype, device) -> torch.Tensor:
    return torch.as_tensor([pos_std**2] * 3 + [q_std**2] * 4 + [vel_std**2] * 3
                           + [ang_std**2] * 3, dtype=dtype, device=device)


def reset_camera_to_gt(state: MonoSlamState, gt_cam13: torch.Tensor,
                       pos_std: float = 0.0, q_comp_std: float = 0.0,
                       vel_std: float = 0.0, ang_vel_std: float = 0.0
                       ) -> MonoSlamState:
    """Manual recovery, the reference's 'u' hotkey: snap the camera state to
    GT, zero the camera-landmark cross-covariance and reinitialize the
    camera covariance diagonal."""
    x = torch.cat([gt_cam13.to(state.x), state.x[_N:]])
    P = state.P.clone()
    P[:_N, :] = 0.0
    P[:, :_N] = 0.0
    P[:_N, :_N] = torch.diag(_cam_diag(pos_std, q_comp_std, vel_std,
                                       ang_vel_std, P.dtype, P.device))
    return state._replace(x=x, P=P)


def reset_state_to_gt(
    params, state: MonoSlamState, gt_cam13: torch.Tensor,
    gt_pix: torch.Tensor, gt_rho: torch.Tensor, slot_mask: torch.Tensor, *,
    impl: int = 2,
    cam_pos_std: float = 0.0, cam_q_comp_std: float = 0.0,
    cam_vel_std: float = 0.0, cam_ang_vel_std: float = 0.0,
    sal_pnt_first_cam_pos_std: float = 0.0, sal_pnt_azimuth_std: float = 0.0,
    sal_pnt_elevation_std: float = 0.0, sal_pnt_inv_dist_std: float = 0.0,
    sal_pnt_pos_std: tuple = (0.0, 0.0, 0.0),
) -> MonoSlamState:
    """Full manual recovery (the reference's 'u' hotkey): rebuild the whole
    state from GT, the camera 13-state and every slot of ``slot_mask``
    re-initialized from its GT pixel ``gt_pix`` [K,2] and inverse distance
    ``gt_rho`` [K], with one of the reference's two covariances:

    impl=1 (SetEstimStateCovarInEstimSpace :2015): camera diagonal from the
      cam_*_std arguments, each landmark a diagonal block from the
      sal_pnt_*_std ones (spherical) or ``sal_pnt_pos_std`` (XYZ), no
      correlations.
    impl=2 (SetEstimStateCovarLikeInAddNewSalPnt :2049): camera block as in
      impl 1, then each landmark's covariance as adding it would give,
      cross-covariances to every variable written before it included.

    Slots outside ``slot_mask`` are zeroed and deactivated. JAX's
    ``lax.scan`` over slots is a loop over the K slots whose writes are
    masked, so nothing is read on the host."""
    from . import landmarks as lm_mod
    Kcap = state.capacity
    dtype, dev = state.x.dtype, state.x.device
    gt_cam13 = gt_cam13.to(dtype=dtype, device=dev)
    gt_pix = gt_pix.to(dtype=dtype, device=dev)
    gt_rho = gt_rho.to(dtype=dtype, device=dev)
    slot_mask = slot_mask.to(device=dev, dtype=torch.bool)
    D = state.x.shape[0]
    x = torch.zeros(D, dtype=dtype, device=dev)
    x[:_N] = gt_cam13
    P = torch.zeros((D, D), dtype=dtype, device=dev)
    P[:_N, :_N] = torch.diag(_cam_diag(cam_pos_std, cam_q_comp_std,
                                       cam_vel_std, cam_ang_vel_std, dtype, dev))
    if impl == 1:
        y = lm_mod.new_landmark_jacobians(params, gt_cam13[:7], gt_pix,
                                          gt_rho)[0]
        if params.sal_pnt_repres == REPRES_XYZ:
            blk = torch.cat([torch.as_tensor(sal_pnt_pos_std, dtype=dtype,
                                             device=dev) ** 2,
                             torch.zeros(3, dtype=dtype, device=dev)])
        else:
            blk = torch.as_tensor(
                [sal_pnt_first_cam_pos_std ** 2] * 3
                + [sal_pnt_azimuth_std ** 2, sal_pnt_elevation_std ** 2,
                   sal_pnt_inv_dist_std ** 2], dtype=dtype, device=dev)
        blk = torch.diag(blk)
        for k in range(Kcap):
            sl = slice(_N + 6 * k, _N + 6 * k + 6)
            ok = slot_mask[k]
            x[sl] = torch.where(ok, y[k], x[sl])
            P[sl, sl] = torch.where(ok, blk, P[sl, sl])
    else:
        for k in range(Kcap):
            sl = slice(_N + 6 * k, _N + 6 * k + 6)
            ok = slot_mask[k]
            y, auto, cross = lm_mod.new_landmark_covariance(
                params, x, P, gt_pix[k], gt_rho[k],
                params.sal_pnt_init_inv_dist_std)
            x[sl] = torch.where(ok, y, x[sl])
            P[sl, :] = torch.where(ok, cross, P[sl, :])
            P[:, sl] = torch.where(ok, cross.T, P[:, sl])
            P[sl, sl] = torch.where(ok, auto, P[sl, sl])
    return state._replace(
        x=x, P=P, lm_active=slot_mask,
        lm_unobserved=torch.where(slot_mask, 0, state.lm_unobserved))


def check_state(state: MonoSlamState, atol: float = 1e-3) -> torch.Tensor:
    """Cheap invariant check (unit quaternion, nonnegative diagonal): a
    0-d bool tensor."""
    q_ok = torch.abs(torch.linalg.norm(state.x[3:7]) - 1.0) < atol
    return q_ok & (torch.diagonal(state.P) >= -atol).all()
