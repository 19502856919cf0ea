"""Similarity alignment (Umeyama) and ATE, the slice's accuracy metric.

Port of ``surikatoko_tpu/geom/align.py`` (least-squares variant).
"""

from __future__ import annotations

import torch


def umeyama_similarity(src: torch.Tensor, dst: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best (s, R, t) with dst ~ s R src + t in least squares. [N,3] inputs."""
    mu_s = src.mean(dim=0)
    mu_d = dst.mean(dim=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U @ Vt))
    ones = torch.ones((), dtype=cov.dtype, device=cov.device)
    dvec = torch.stack([ones, ones, d])
    R = U @ torch.diag(dvec) @ Vt
    var_s = torch.mean(torch.sum(sc * sc, dim=1))
    s = torch.sum(S * dvec) / var_s
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def apply_similarity(s, R, t, x: torch.Tensor) -> torch.Tensor:
    return s * (x @ R.T) + t


def aligned_rmse(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """RMSE after optimal similarity alignment (ATE for trajectories)."""
    s, R, t = umeyama_similarity(src, dst)
    d = apply_similarity(s, R, t, src) - dst
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=1)))
