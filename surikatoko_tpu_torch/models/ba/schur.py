"""Correction solvers: Schur-complement two-phase solve + naive dense
cross-check.

Port of ``surikatoko_tpu/models/ba/schur.py`` (reference
EstimateCorrectionsDecomposedInTwoPhases, bundle-adj-kanatani.cpp:1771-1995):
eliminate the 3Np point block via batched 3x3 inverses, reduce onto the 10F
camera system (S = G - sum_i F_i^T E_i^-1 F_i), solve, back-substitute
points.

Damping is multiplicative on the diagonal (x(1+factor), reference
:1817-1833). Gauge-fixed variables carry zero rows/cols with a unit
diagonal, so they solve to exactly zero correction.

A failed factorization comes back as ``ok = False``, never as an exception
or a host sync: the ``*_ex`` factorizations report ``info`` on the device
and it is folded into ``ok`` with the finiteness checks (the JAX package's
factorizations return NaN instead, which its ``ok`` catches).

Solves H d = -g; returns (dX [Np,3], du [F,10], ok).
"""

from __future__ import annotations

import torch

from surikatoko_tpu_torch.models.ba.derivs import (
    FRAME_VARS, GNBlocks, frame_var_mask)


def _damp(M: torch.Tensor, factor) -> torch.Tensor:
    """diag *= (1 + factor) on the trailing square dims."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + M * eye * factor


def _fixed_var_identity(G: torch.Tensor, fmask: torch.Tensor) -> torch.Tensor:
    """Set unit diagonal on gauge-fixed frame vars so the system stays SPD."""
    fixed = (~fmask).to(G.dtype)
    eye = torch.eye(FRAME_VARS, dtype=G.dtype, device=G.device)
    return G + eye[None] * fixed[:, None, :]


def add_block_diag_(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """S [10F,10F] += block-diagonal of G [F,10,10], in place."""
    F = G.shape[0]
    S.view(F, FRAME_VARS, F, FRAME_VARS).diagonal(dim1=0, dim2=2).add_(
        G.permute(1, 2, 0))
    return S


def preconditioned_cholesky_solve(S: torch.Tensor, rhs: torch.Tensor):
    """Solve S x = rhs through Jacobi symmetric preconditioning and a
    Cholesky factor: (x, info). The preconditioning is essential in f32 at
    5000+ unknowns (pixel^2 and radian^2 diagonal entries differ by ~1e6)."""
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(S)), min=1e-12))
    dinv = 1.0 / d
    Sp = S * dinv[:, None] * dinv[None, :]
    L, info = torch.linalg.cholesky_ex(Sp)
    x = dinv * torch.cholesky_solve((rhs * dinv)[:, None], L)[:, 0]
    return x, info


def all_finite(*xs: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.isfinite(x).all() for x in xs]).all()


def solve_corrections_schur(blocks: GNBlocks, hessian_factor,
                            unity_comp_ind: int = 1,
                            optimize_intrinsics: bool = True,
                            pin_frames: tuple = ()):
    """Two-phase solve. Returns (dX, du, ok) where ok=False if a
    factorization failed or the result is not finite."""
    Np, F = blocks.Fpf.shape[0], blocks.Fpf.shape[1]
    fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics, pin_frames,
                           blocks.E.device)

    E = _damp(blocks.E, hessian_factor)                       # [Np,3,3]
    G = _fixed_var_identity(_damp(blocks.G, hessian_factor), fmask)

    Einv, info_E = torch.linalg.inv_ex(E)                     # batched 3x3
    # C_ij = E_i^-1 F_ij : [Np,F,3,10]
    C = torch.einsum("iab,ifbc->ifac", Einv, blocks.Fpf)
    # S_jl = delta_jl G_j - sum_i F_ij^T C_il  (reduced camera system)
    S = add_block_diag_(-torch.einsum("ifab,igac->fbgc", blocks.Fpf, C)
                        .reshape(F * FRAME_VARS, F * FRAME_VARS), G)

    # rhs_f = -(gf - sum_i F_ij^T E_i^-1 gp_i)
    w = torch.einsum("iab,ib->ia", Einv, blocks.gp)           # [Np,3]
    rhs = -(blocks.gf - torch.einsum("ifab,ia->fb", blocks.Fpf, w))
    du, info_S = preconditioned_cholesky_solve(S, rhs.reshape(-1))
    du = du.reshape(F, FRAME_VARS)
    # back-substitute points: dX_i = -E_i^-1 (gp_i + sum_j F_ij du_j)
    dX = -torch.einsum("iab,ib->ia", Einv,
                       blocks.gp + torch.einsum("ifab,fb->ia", blocks.Fpf, du))
    ok = all_finite(du, dX) & (info_S == 0) & torch.all(info_E == 0)
    return dX, du, ok


def solve_corrections_naive(blocks: GNBlocks, hessian_factor,
                            unity_comp_ind: int = 1,
                            optimize_intrinsics: bool = True,
                            pin_frames: tuple = ()):
    """Assemble the full dense Hessian and solve — the reference
    EstimateCorrectionsNaive (:1700), kept as the numeric cross-check."""
    Np, F = blocks.Fpf.shape[0], blocks.Fpf.shape[1]
    n_p = Np * 3
    fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics, pin_frames,
                           blocks.E.device)

    E = _damp(blocks.E, hessian_factor)
    G = _fixed_var_identity(_damp(blocks.G, hessian_factor), fmask)
    Hpf = blocks.Fpf.permute(0, 2, 1, 3).reshape(n_p, F * FRAME_VARS)
    H = torch.cat([torch.cat([torch.block_diag(*E), Hpf], dim=1),
                   torch.cat([Hpf.T, add_block_diag_(
                       G.new_zeros(F * FRAME_VARS, F * FRAME_VARS), G)],
                             dim=1)], dim=0)
    g = torch.cat([blocks.gp.reshape(-1), blocks.gf.reshape(-1)])
    d, info = torch.linalg.solve_ex(H, -g)
    dX = d[:n_p].reshape(Np, 3)
    du = d[n_p:].reshape(F, FRAME_VARS)
    ok = torch.isfinite(d).all() & (info == 0)
    return dX, du, ok


def solve_corrections_steepest_descent(blocks: GNBlocks, step):
    """Gradient step fallback (reference EstimateCorrectionsSteepestDescent
    :1681)."""
    return -step * blocks.gp, -step * blocks.gf
