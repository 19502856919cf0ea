"""Similarity alignment (Umeyama, least squares and outlier-tolerant) and
ATE, the accuracy metric of the port's runs.

Port of ``surikatoko_tpu/geom/align.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def _median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median that averages the two middle values of an even count (as
    numpy's and JAX's; ``torch.median`` takes the lower one)."""
    return torch.quantile(x, 0.5, dim=dim)


def _sign_vec(d: torch.Tensor) -> torch.Tensor:
    """[..., 3] = (1, 1, d)."""
    ones = torch.ones_like(d)
    return torch.stack([ones, ones, d], dim=-1)


def umeyama_similarity(src: torch.Tensor, dst: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best (s, R, t) with dst ~ s R src + t in least squares. [..., N, 3]
    inputs; a leading batch of point sets gives a batch of fits."""
    mu_s = src.mean(dim=-2)
    mu_d = dst.mean(dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = dc.transpose(-1, -2) @ sc / src.shape[-2]
    U, S, Vt = torch.linalg.svd(cov)
    dvec = _sign_vec(torch.sign(torch.linalg.det(U @ Vt)))
    R = (U * dvec[..., None, :]) @ Vt
    var_s = torch.mean(torch.sum(sc * sc, dim=-1), dim=-1)
    s = torch.sum(S * dvec, dim=-1) / var_s
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def apply_similarity(s, R, t, x: torch.Tensor) -> torch.Tensor:
    """s R x + t for points x [..., N, 3] (a batch of fits broadcasts)."""
    s = torch.as_tensor(s)
    return s[..., None, None] * (x @ R.transpose(-1, -2)) + t[..., None, :]


def umeyama_similarity_robust(
    src: torch.Tensor, dst: torch.Tensor, *,
    iters: int = 256, seed: int = 0, refits: int = 2,
    inlier_scale: float = 3.5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Outlier-tolerant (s, R, t): least median of squares over 3-point
    minimal Umeyama hypotheses, then MAD-gated inlier refits. Returns (s, R,
    t, inliers [N]).

    The hypotheses' distinct index triples are the top 3 of iid uniforms
    per hypothesis, drawn from ``np.random.default_rng(seed)`` (the JAX
    package draws them from a key, so the two sample other triples; the
    refits on the same inliers give the same fit). All hypotheses are one
    batch of 3x3 SVDs; the ``refits`` are a Python loop."""
    N = src.shape[0]
    u = np.random.default_rng(seed).uniform(size=(iters, N))
    samples = torch.as_tensor(np.argsort(-u, axis=1, kind="stable")[:, :3],
                              device=src.device)
    s_h, R_h, t_h = umeyama_similarity(src[samples], dst[samples])
    resid = torch.linalg.norm(apply_similarity(s_h, R_h, t_h, src) - dst,
                              dim=-1)                               # [iters, N]
    med = _median(resid, dim=1)
    # a (near-)collinear triple can give a non-finite hypothesis: it never
    # wins the argmin
    med = torch.where(torch.isfinite(med), med, torch.inf)
    best = torch.argmin(med)
    r_best = resid[best]
    scale_d = torch.sqrt(torch.mean(torch.sum(
        (dst - dst.mean(dim=0)) ** 2, dim=1)))
    sigma_floor = torch.clamp(1e-5 * scale_d, min=1e-12)
    sigma = 1.4826 * _median(torch.abs(r_best - _median(r_best)))
    thresh = inlier_scale * torch.maximum(sigma, sigma_floor)
    inliers = r_best <= torch.maximum(thresh, torch.min(r_best))

    s, R, t = s_h[best], R_h[best], t_h[best]
    for _ in range(refits):
        w = inliers.to(src.dtype)[:, None]
        n_inl = torch.sum(w)
        n = torch.clamp(n_inl, min=3.0)
        mu_s = torch.sum(src * w, dim=0) / n
        mu_d = torch.sum(dst * w, dim=0) / n
        d_s, d_d = src - mu_s, dst - mu_d
        cov = (d_d * w).T @ d_s / n
        U, S, Vt = torch.linalg.svd(cov)
        dvec = _sign_vec(torch.sign(torch.linalg.det(U @ Vt)))
        R_n = (U * dvec[None, :]) @ Vt
        var_s = torch.sum(torch.sum(d_s * d_s, dim=1) * w[:, 0]) / n
        # var_s is 0 when fewer than 3 inliers survive a gate
        s_n = torch.sum(S * dvec) / torch.clamp(var_s, min=1e-12)
        t_n = mu_d - s_n * (R_n @ mu_s)
        # keep the previous fit where the refit is under-determined
        ok = ((n_inl >= 3.0) & torch.isfinite(s_n)
              & torch.isfinite(R_n).all() & torch.isfinite(t_n).all())
        s = torch.where(ok, s_n, s)
        R = torch.where(ok, R_n, R)
        t = torch.where(ok, t_n, t)
        r = torch.linalg.norm(apply_similarity(s, R, t, src) - dst, dim=1)
        sg = 1.4826 * _median(torch.abs(r - _median(r)))
        inliers = r <= torch.maximum(
            inlier_scale * torch.maximum(sg, sigma_floor), torch.min(r))
    return s, R, t, inliers


def aligned_rmse(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """RMSE after optimal similarity alignment (ATE for trajectories)."""
    s, R, t = umeyama_similarity(src, dst)
    d = apply_similarity(s, R, t, src) - dst
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=1)))
