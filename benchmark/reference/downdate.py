"""The covariance downdate P' = k k^T o (P - M^T M), lower triangle
mirrored: plain PyTorch (the reference's stand-in for kernel B2)."""

from __future__ import annotations

import torch


def symmetric_downdate(P: torch.Tensor, M: torch.Tensor,
                       keep: torch.Tensor | None = None) -> torch.Tensor:
    """X = P o kk^T - (M o k)^T (M o k) (``keep=None``: P - M^T M), then
    its lower triangle mirrored up. P [D,D], M [m,D], keep [D]."""
    if keep is None:
        X = torch.addmm(P, M.T, M, alpha=-1)
    else:
        Mk = M * keep[None, :]
        X = torch.addmm(P * (keep[:, None] * keep[None, :]), Mk.T, Mk,
                        alpha=-1)
    return torch.tril(X) + torch.tril(X, -1).T
