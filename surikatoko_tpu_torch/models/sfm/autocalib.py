"""Auto-calibration via the image of the absolute conic (IAC).

Port of ``surikatoko_tpu/models/sfm/autocalib.py`` (capability match for
the reference prototype's auto-calibration block, py_proto/suriko/
mvg.py:2848-3120). Two classical routes, both linear in the IAC omega =
K^-T K^-1 followed by a Cholesky extraction of K:

* :func:`calibrate_from_homographies`: Zhang's method, two constraints
  h1^T w h2 = 0 and h1^T w h1 = h2^T w h2 per plane homography.
* :func:`calibrate_from_rotation_homographies`: a rotating camera's
  infinite homographies H ~ K R K^-1 preserve the dual IAC K K^T.

Homographies are [..., M, 3, 3]: a leading batch of problems gives a batch
of K (one batched SVD and one batched Cholesky).
"""

from __future__ import annotations

import torch

_W_ENTRIES = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _vij(H: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Zhang's v_ij row: the constraint h_i^T w h_j in terms of the 6-vector
    w = [w11, w12, w22, w13, w23, w33]."""
    h_i = H[..., :, i]
    h_j = H[..., :, j]
    return torch.stack([
        h_i[..., 0] * h_j[..., 0],
        h_i[..., 0] * h_j[..., 1] + h_i[..., 1] * h_j[..., 0],
        h_i[..., 1] * h_j[..., 1],
        h_i[..., 2] * h_j[..., 0] + h_i[..., 0] * h_j[..., 2],
        h_i[..., 2] * h_j[..., 1] + h_i[..., 1] * h_j[..., 2],
        h_i[..., 2] * h_j[..., 2],
    ], dim=-1)


def _sym3(w: torch.Tensor, order) -> torch.Tensor:
    """[..., 6] -> the symmetric [..., 3, 3] whose (a, b) entries in
    ``order`` are w's."""
    idx = {}
    for k, (a, b) in enumerate(order):
        idx[a, b] = idx[b, a] = k
    return torch.stack([w[..., idx[a, b]] for a in range(3) for b in range(3)],
                       dim=-1).reshape(w.shape[:-1] + (3, 3))


def _masked_rows(A: torch.Tensor, mask) -> torch.Tensor:
    """[..., M, r, 6] rows with masked views zeroed, as [..., M r, 6]."""
    if mask is not None:
        A = A * mask[..., None, None].to(A.dtype)
    return A.reshape(A.shape[:-3] + (-1, 6))


def _last_right_singular(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svd(A, full_matrices=True)[2][..., -1, :]


def _omega_to_K(w6: torch.Tensor) -> torch.Tensor:
    """K (upper triangular, K[2,2] = 1) from the IAC 6-vector via the
    Cholesky factor of omega = K^-T K^-1."""
    W = _sym3(w6, ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2)))
    W = W * torch.sign(w6[..., 0])[..., None, None]       # positive definite
    W = W / W[..., 2:3, 2:3] * 1.0
    L = torch.linalg.cholesky(W)          # W = L L^T, L lower triangular
    K = torch.linalg.inv(L.transpose(-1, -2))             # K^-1 = L^T
    return K / K[..., 2:3, 2:3]


def calibrate_from_homographies(Hs: torch.Tensor,
                                mask: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """K [..., 3, 3] from >= 3 plane homographies [..., M, 3, 3] (Zhang).
    Masked views contribute zero rows."""
    rows = torch.stack([_vij(Hs, 0, 1), _vij(Hs, 0, 0) - _vij(Hs, 1, 1)],
                       dim=-2)                                   # [..., M, 2, 6]
    return _omega_to_K(_last_right_singular(_masked_rows(rows, mask)))


def calibrate_from_rotation_homographies(Hs: torch.Tensor,
                                         mask: torch.Tensor | None = None,
                                         ) -> torch.Tensor:
    """K from the infinite homographies of a rotating camera, H_i ~ K R_i
    K^-1: the dual IAC w* = K K^T satisfies w* = H w* H^T, six linear
    equations per view on the symmetric w* (H scaled to det(H) = 1). The
    equations are linear in w*, so their coefficient rows (the Jacobian the
    JAX package takes with ``jacfwd``) are the residuals at the unit
    6-vectors."""
    det = torch.linalg.det(Hs)
    Hn = Hs / (torch.sign(det) * torch.abs(det) ** (1.0 / 3.0))[..., None, None]
    cols = []
    for k in range(6):
        e = torch.zeros(6, dtype=Hs.dtype, device=Hs.device)
        e[k] = 1.0
        E = _sym3(e, _W_ENTRIES)
        R = Hn @ E @ Hn.transpose(-1, -2) - E
        cols.append(torch.stack([R[..., a, b] for a, b in _W_ENTRIES], dim=-1))
    rows = torch.stack(cols, dim=-1)                             # [..., M, 6, 6]
    w6 = _last_right_singular(_masked_rows(rows, mask))
    Wd = _sym3(w6, _W_ENTRIES)
    Wd = Wd * torch.sign(w6[..., 0])[..., None, None]
    Wd = Wd / Wd[..., 2:3, 2:3]
    # w* = K K^T with K upper triangular: the Cholesky factor of the
    # reversed matrix, reversed back
    Pr = torch.tensor([[0.0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=Hs.dtype,
                      device=Hs.device)
    K = Pr @ torch.linalg.cholesky(Pr @ Wd @ Pr) @ Pr
    return K / K[..., 2:3, 2:3]
