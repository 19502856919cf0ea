"""Batched Gauss-Newton blocks for BA via forward-mode autodiff.

Port of ``surikatoko_tpu/models/ba/derivs.py``. It replaces the reference's
closed-form "pqr" derivatives (ComputeCloseFormReprErrorDerivatives,
bundle-adj-kanatani.cpp:1140-1548). Per observation (i,j) the residual
r(X_i, u_j) depends on the point (3 vars) and the frame's 10 local vars
u = [dfx dfy du0 dv0 dTx dTy dTz dWx dWy dWz], all zero at the
linearization point (T/W are increments on the *direct* camera pose; the
rotation increment is left-multiplied Rodrigues, reference IncrementRotMat
:59). ``torch.func.jacfwd`` over (X, u) inside two ``torch.func.vmap``s
gives every observation's Jacobians as one batch of tensor ops.

Blocks (Gauss-Newton, i.e. Kanatani's normal equations):
  E_i  = sum_j Jp^T Jp     [Np,3,3]     point-point
  G_j  = sum_i Jf^T Jf     [F,10,10]    frame-frame (block diag)
  F_ij = Jp^T Jf           [Np,F,3,10]  point-frame
  gp_i = sum_j Jp^T r      [Np,3]
  gf_j = sum_i Jf^T r      [F,10]

Gauge fixing: the fixed vars are masked out of Jf; their corrections solve
to exactly 0 through a unit diagonal (schur._fixed_var_identity).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from surikatoko_tpu_torch.geom import so3
from surikatoko_tpu_torch.models.ba.problem import BAProblem

FRAME_VARS = 10


class GNBlocks(NamedTuple):
    E: torch.Tensor      # [Np, 3, 3]
    G: torch.Tensor      # [F, 10, 10]
    Fpf: torch.Tensor    # [Np, F, 3, 10]
    gp: torch.Tensor     # [Np, 3]
    gf: torch.Tensor     # [F, 10]


def frame_var_mask(n_frames: int, unity_comp_ind: int = 1,
                   optimize_intrinsics: bool = True, pin_frames: tuple = (),
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """[F,10] bool mask of FREE frame variables under the normalization gauge:
    frame 0 keeps only intrinsics; frame 1 loses T[unity_comp]; others free.
    ``optimize_intrinsics=False`` pins the four intrinsic vars of every
    frame; ``pin_frames`` freezes the pose (T, W) of more frames."""
    # every write a slice, so a fill on the device: a one-element index
    # would copy a host scalar up (a sync, and no CUDA graph can capture it)
    mask = torch.ones((n_frames, FRAME_VARS), dtype=torch.bool, device=device)
    mask[0, 4:] = False
    mask[1, 4 + unity_comp_ind:5 + unity_comp_ind] = False
    for f in pin_frames:
        mask[int(f), 4:] = False
    if not optimize_intrinsics:
        mask[:, :4] = False
    return mask


def _residual_one(K, R_cfw, t_cfw, obs_f0, X, u):
    """Residual [2] of one observation as a function of point X and the local
    frame increment u (zeros at linearization)."""
    z = torch.zeros_like(u[0])
    dK = torch.stack([torch.stack([u[0], z, u[2]]),
                      torch.stack([z, u[1], u[3]]),
                      torch.stack([z, z, z])])
    Kp = K + dK
    # direct pose: R_d = R_cfw^T, t_d = -R_cfw^T t_cfw; increments apply there
    R_d = R_cfw.mT
    t_d = -R_d @ t_cfw
    R_d_new = so3.exp(u[7:10]) @ R_d
    t_d_new = t_d + u[4:7]
    x_cam = R_d_new.mT @ (X - t_d_new)
    x_h = Kp @ x_cam
    return x_h[:2] / x_h[2] - obs_f0


def per_obs_jacobians(K, R, t, o, X):
    """(r [2], Jp [2,3], Jf [2,10]) of one observation at u = 0."""
    def f(XX, uu):
        r = _residual_one(K, R, t, o, XX, uu)
        return r, r
    u0 = torch.zeros(FRAME_VARS, dtype=X.dtype, device=X.device)
    (Jp, Jf), r = jacfwd(f, argnums=(0, 1), has_aux=True)(X, u0)
    return r, Jp, Jf


def _jacobians(p: BAProblem):
    """Per-observation residual + Jacobians over the dense grid, masked.
    Returns r [Np,F,2], Jp [Np,F,2,3], Jf [Np,F,2,10]."""
    per_frame = vmap(per_obs_jacobians, in_dims=(0, 0, 0, 0, None))  # over F
    per_point = vmap(per_frame, in_dims=(None, None, None, 0, 0))     # over Np
    r, Jp, Jf = per_point(p.K, p.cfw_R, p.cfw_t, p.obs / p.f0, p.points)
    m = p.obs_mask[..., None].to(p.points.dtype)
    return r * m, Jp * m[..., None], Jf * m[..., None]


def compute_blocks(p: BAProblem, unity_comp_ind: int = 1,
                   fix_gauge: bool = True, optimize_intrinsics: bool = True,
                   pin_frames: tuple = ()) -> GNBlocks:
    r, Jp, Jf = _jacobians(p)
    if fix_gauge:
        fmask = frame_var_mask(p.n_frames, unity_comp_ind, optimize_intrinsics,
                               pin_frames, p.points.device).to(p.points.dtype)
        Jf = Jf * fmask[None, :, None, :]

    E = torch.einsum("ifca,ifcb->iab", Jp, Jp)
    # points observed nowhere get a unit E block: gp=0 and F=0 for them, so
    # their corrections solve to exactly zero instead of inf
    unseen = (~torch.any(p.obs_mask, dim=1)).to(E.dtype)
    E = E + torch.eye(3, dtype=E.dtype, device=E.device) * unseen[:, None, None]
    G = torch.einsum("ifca,ifcb->fab", Jf, Jf)
    Fpf = torch.einsum("ifca,ifcb->ifab", Jp, Jf)
    gp = torch.einsum("ifca,ifc->ia", Jp, r)
    gf = torch.einsum("ifca,ifc->fa", Jf, r)
    return GNBlocks(E=E, G=G, Fpf=Fpf, gp=gp, gf=gf)


def apply_corrections(p, dX: torch.Tensor, du: torch.Tensor):
    """Reference ApplyCorrections (bundle-adj-kanatani.cpp:1997-2063):
    X += dX; K += dK; direct T += dT; direct R <- Rodrigues(dW) R. Touches
    only points/K/cfw_R/cfw_t, so it takes the dense and the sparse problem
    alike."""
    z = torch.zeros_like(du[:, 0])
    dK = torch.stack([torch.stack([du[:, 0], z, du[:, 2]], -1),
                      torch.stack([z, du[:, 1], du[:, 3]], -1),
                      torch.stack([z, z, z], -1)], -2)
    K = p.K + dK
    R_d = p.cfw_R.mT
    t_d = -torch.einsum("fij,fj->fi", R_d, p.cfw_t)
    R_d = so3.exp(du[:, 7:10]) @ R_d
    t_d = t_d + du[:, 4:7]
    cfw_R = R_d.mT
    cfw_t = -torch.einsum("fij,fj->fi", cfw_R, t_d)
    return p._replace(points=p.points + dX, K=K, cfw_R=cfw_R, cfw_t=cfw_t)
