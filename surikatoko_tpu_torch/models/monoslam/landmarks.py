"""Landmark initialization: inverse-depth state, its covariance, slot add.

Port of ``surikatoko_tpu/models/monoslam/landmarks.py`` (reference
GetNewSphericalSalientPointState :2398 (A.58), GetNewSphericalSalientPoint-
Covar :2457 (A.67-A.79), AddSalientPoint :2597). The Jacobians of the
initialization function come from ``torch.func.jacfwd``, so
:func:`new_landmark_state` stays free of in-place ops and value branches.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from surikatoko_tpu_torch.geom import camera as cam_mod
from surikatoko_tpu_torch.geom import quat
from surikatoko_tpu_torch.models.monoslam.state import (
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


def new_landmark_covariance(params: MonoSlamParams, x: torch.Tensor,
                            P: torch.Tensor, pix: torch.Tensor,
                            inv_dist: torch.Tensor, inv_dist_std: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [6], autocovar [6,6], cross-covar with all D vars [6,D]) by
    first-order propagation (A.67-A.79)."""
    cam_pq = x[:7]
    g = lambda c, p, rho: new_landmark_state(params, c, p, rho)
    y = g(cam_pq, pix, inv_dist)
    J_cam, J_pix, J_rho = jacfwd(g, argnums=(0, 1, 2))(cam_pq, pix, inv_dist)
    r_var = params.measurm_noise_var.to(x.dtype)
    auto = J_cam @ P[:7, :7] @ J_cam.T + r_var * (J_pix @ J_pix.T)
    auto = auto + (inv_dist_std.to(x.dtype) ** 2) * torch.outer(J_rho, J_rho)
    cross = J_cam @ P[:7, :]
    return y, auto, cross


def add_landmarks(params: MonoSlamParams, state: MonoSlamState,
                  new_pix: torch.Tensor, new_mask: torch.Tensor,
                  gt_inv_dist: torch.Tensor | None = None
                  ) -> tuple[MonoSlamState, torch.Tensor]:
    """Claim the first free slot for each valid candidate in order. Returns
    (state, slot ids [M] int32, -1 where not added).

    The reference scan selects a whole new P per candidate; here the slot's
    rows, columns and block are written in place under the candidate's
    ``do`` mask (an unclaimed candidate writes the values already there).
    This runs at initialization only, so it stays a plain loop."""
    Kcap = state.capacity
    dtype, dev = state.x.dtype, state.x.device
    x, P = state.x.clone(), state.P.clone()
    active = state.lm_active.clone()
    unobs = state.lm_unobserved.clone()
    gen = state.lm_generation.clone()
    rho_std = params.sal_pnt_init_inv_dist_std
    if gt_inv_dist is None:
        gt_inv_dist = torch.full((new_pix.shape[0],), float("nan"),
                                 dtype=dtype, device=dev)
    slots = []
    six = torch.arange(6, device=dev)
    for pix, ok, rho_gt in zip(new_pix, new_mask, gt_inv_dist):
        free = ~active
        slot = torch.argmax(free.to(torch.int32))
        do = ok & free.any()
        rho = torch.where(torch.isnan(rho_gt),
                          params.sal_pnt_init_inv_dist.to(dtype), rho_gt)
        y, auto, cross = new_landmark_covariance(params, x, P, pix, rho,
                                                 rho_std)
        idx = _N + slot * 6 + six
        x[idx] = torch.where(do, y, x[idx])
        P[idx, :] = torch.where(do, cross, P[idx, :])
        P[:, idx] = torch.where(do, cross.T, P[:, idx])
        blk = (idx[:, None], idx[None, :])
        P[blk] = torch.where(do, auto, P[blk])
        active[slot] = active[slot] | do
        unobs[slot] = torch.where(do, 0, unobs[slot])
        gen[slot] = gen[slot] + do.to(torch.int32)
        slots.append(torch.where(do, slot, -1))
    slots = (torch.stack(slots).to(torch.int32) if slots
             else torch.zeros(0, dtype=torch.int32, device=dev))
    return state._replace(x=x, P=P, lm_active=active, lm_unobserved=unobs,
                          lm_generation=gen), slots
