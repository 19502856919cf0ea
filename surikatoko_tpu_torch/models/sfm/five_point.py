"""Minimal 5-point relative pose (essential matrix) solver.

Port of ``surikatoko_tpu/models/sfm/five_point.py`` (capability match for
the reference prototype's Stewenius solver, py_proto/suriko/
ess_5point_stewenius.py), batched over hypotheses:

1. nullspace: E(x,y,z) = x E1 + y E2 + z E3 + E4 from the 5 epipolar
   equations (4-dim right nullspace of the 5x9 system);
2. the 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
   expanded into the 20 degree-<=3 monomials numerically: each polynomial
   evaluated at 40 fixed sample points and fitted by least squares to the
   Vandermonde system (exact for cubics);
3. Gauss-Jordan reduction of the 10x20 system to [I | A], the 10x10 action
   matrix of multiplication by x, whose eigenvectors evaluate the basis
   monomials at each of the <= 10 solutions.

The 10x10 nonsymmetric eigendecompositions run as one batched
``torch.linalg.eig`` in float64 on the host, as the JAX package hands them
to numpy: one copy each way for the whole batch (``mvg.host_eig``).
"""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch.models.sfm.mvg import host_eig, sampson_distance_sq

# monomial exponent table, degree <= 3 in (x, y, z); the first 10 (degree
# 3) columns are eliminated and the last 10 form the quotient basis:
# [x^3 x^2y xy^2 y^3 x^2z xyz y^2z xz^2 yz^2 z^3 | x^2 xy y^2 xz yz z^2 x y z 1]
_EXPS = np.array([
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1), (1, 1, 1),
    (0, 2, 1), (1, 0, 2), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
])
# basis = columns 10..19: [x^2, xy, y^2, xz, yz, z^2, x, y, z, 1]; x * basis
# = [x^3, x^2y, xy^2, x^2z, xyz, xz^2, x^2, xy, xz, x]
_XB_TO_COL = [0, 1, 2, 4, 5, 7, 10, 11, 13, 16]  # column of x*basis[i] in _EXPS
# the fixed generic sample points of the expansion
_SAMPLE_PTS = np.random.default_rng(12345).normal(size=(40, 3))


def _monomials(pts: torch.Tensor) -> torch.Tensor:
    """[N,3] sample points -> [N,20] monomial values."""
    x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
    e = torch.as_tensor(_EXPS, dtype=pts.dtype, device=pts.device)
    return x ** e[:, 0][None] * y ** e[:, 1][None] * z ** e[:, 2][None]


def _constraints_at(Es: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints at E [..., 3, 3]: returns [..., 10]."""
    EEt = Es @ Es.transpose(-1, -2)
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)
    T = 2.0 * (EEt @ Es) - tr[..., None, None] * Es
    return torch.cat([torch.linalg.det(Es)[..., None],
                      T.reshape(Es.shape[:-2] + (9,))], dim=-1)


def five_point_essential(x1n: torch.Tensor, x2n: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Essential-matrix candidates from exactly 5 correspondences in
    normalized (calibrated) coordinates [..., 5, 2] each.

    Returns (Es [..., 10, 3, 3], valid [..., 10]): up to 10 real solutions;
    the slots of complex roots are flagged False. The order of the
    candidates is the eigensolver's."""
    dtype, dev = x1n.dtype, x1n.device
    batch = x1n.shape[:-2]
    ones = torch.ones_like(x1n[..., :1])
    X1 = torch.cat([x1n, ones], dim=-1)
    X2 = torch.cat([x2n, ones], dim=-1)
    # x2^T E x1 = sum E_ij x2_i x1_j
    A = (X2[..., :, None] * X1[..., None, :]).reshape(batch + (5, 9))
    Vt = torch.linalg.svd(A, full_matrices=True)[2]
    Eb = torch.stack([Vt[..., -k, :].reshape(batch + (3, 3))
                      for k in (1, 2, 3, 4)], dim=-3)        # [..., 4, 3, 3]

    def E_of(p):
        """[..., P, 3] -> [..., P, 3, 3]: x E1 + y E2 + z E3 + E4."""
        E1, E2, E3, E4 = (Eb[..., None, k, :, :] for k in range(4))
        return (p[..., 0, None, None] * E1 + p[..., 1, None, None] * E2
                + p[..., 2, None, None] * E3 + E4)

    pts = torch.as_tensor(_SAMPLE_PTS, dtype=dtype, device=dev)
    V = _monomials(pts)                                       # [40, 20]
    vals = _constraints_at(E_of(pts.expand(batch + (40, 3))))  # [..., 40, 10]
    coeffs = torch.linalg.lstsq(V.expand(batch + (40, 20)), vals).solution
    M = coeffs.transpose(-1, -2)                              # [..., 10, 20]
    Ared = torch.linalg.solve(M[..., :10], M[..., 10:])       # [..., 10, 10]

    # action matrix of multiplication by x on the basis
    Ax = torch.zeros(batch + (10, 10), dtype=dtype, device=dev)
    for i, col in enumerate(_XB_TO_COL):
        if col < 10:
            Ax[..., i, :] = -Ared[..., col, :]    # degree-3 monomial -> -A row
        else:
            Ax[..., i, col - 10] = 1.0
    w, v = host_eig(torch.linalg.eig, Ax.to(torch.float64))
    # real eigenvalues -> real solutions; basis vector v = [.., x, y, z, 1]
    vr = v.real.transpose(-1, -2).to(dtype)       # [..., 10 eigvecs, 10 comps]
    wi = w.imag.to(dtype)
    denom = vr[..., 9]
    safe = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    xyz = vr[..., 6:9] / safe[..., None]
    valid = (torch.abs(wi) < 1e-6) & (torch.abs(denom) >= 1e-12)
    Es = E_of(xyz)
    norms = torch.sqrt(torch.sum(Es * Es, dim=(-2, -1)))
    return Es / torch.clamp(norms, min=1e-30)[..., None, None], valid


def five_point_best(x1n: torch.Tensor, x2n: torch.Tensor,
                    x1_all: torch.Tensor, x2_all: torch.Tensor,
                    mask_all: torch.Tensor) -> torch.Tensor:
    """The 5-point candidate [..., 3, 3] with the lowest total Sampson error
    over a support set (RANSAC scoring / disambiguation)."""
    Es, valid = five_point_essential(x1n, x2n)
    m = mask_all.to(x1_all.dtype)
    scores = torch.sum(sampson_distance_sq(Es, x1_all, x2_all) * m, dim=-1)
    scores = torch.where(valid, scores, torch.inf)
    i = torch.argmin(scores, dim=-1)
    return torch.take_along_dim(Es, i[..., None, None, None], dim=-3)[..., 0, :, :]
