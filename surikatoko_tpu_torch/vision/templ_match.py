"""Zero-normalized cross-correlation (ZNCC) surfaces, batched over landmarks.

Port of ``surikatoko_tpu/vision/templ_match.py`` (reference
templ-match.cpp:7-112). This is the plain PyTorch version behind the
hand-written search kernel (ops/ncc_cuda.py):

  corr_prod = corr(f, t - mean(t))     (the f-mean term cancels)
  win_sum, win_sum2 = box filters of f, f^2
  corr = corr_prod / (sqrt(win_sum2 - win_sum^2/N) * |t - mean(t)|)

as grouped (depthwise) correlations. On the card they run through cuDNN,
so TF32 must be off (config.set_full_precision).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class TemplateStats(NamedTuple):
    """Per-template stats (reference TemplMatchStats, davison-mono-slam.h:110)."""

    mean: torch.Tensor                # [K]
    sqrt_sum_sqr_diff: torch.Tensor   # [K]


def template_stats(templates: torch.Tensor) -> TemplateStats:
    """templates [K,T,T] -> (mean [K], sqrt(sum((t-mean)^2)) [K])."""
    mean = templates.mean(dim=(-2, -1))
    d = templates - mean[:, None, None]
    return TemplateStats(mean=mean,
                         sqrt_sum_sqr_diff=torch.sqrt(torch.sum(d * d, dim=(-2, -1))))


def _depthwise_corr(patches: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """patches [K,P,P] (x) kernels [K,T,T] -> valid correlation [K,S,S]."""
    K = patches.shape[0]
    return F.conv2d(patches[None], kernels[:, None], groups=K)[0]


def corr_coeff_surface(patches: torch.Tensor, templates: torch.Tensor,
                       stats: TemplateStats | None = None,
                       eps: float = 1e-12) -> torch.Tensor:
    """ZNCC surface [K,S,S] of each search patch [K,P,P] against its template
    [K,T,T] (S = P - T + 1); ~zero-variance windows get corr 0."""
    Kn = patches.shape[0]
    T = templates.shape[-1]
    n = T * T
    st = stats or template_stats(templates)
    corr_prod = _depthwise_corr(patches, templates - st.mean[:, None, None])
    ones = torch.ones((Kn, T, T), dtype=patches.dtype, device=patches.device)
    win_sum = _depthwise_corr(patches, ones)
    win_sum2 = _depthwise_corr(patches * patches, ones)
    var_term = torch.clamp(win_sum2 - win_sum * win_sum / n, min=0.0)
    denom = torch.sqrt(var_term) * st.sqrt_sum_sqr_diff[:, None, None]
    ok = denom > eps
    return torch.where(ok, corr_prod / torch.where(ok, denom, 1.0), 0.0)


def corr_coeff_single(image_roi: torch.Tensor, template: torch.Tensor
                      ) -> torch.Tensor:
    """Scalar ZNCC of one window against one template (reference
    CalcCorrCoeff)."""
    return corr_coeff_surface(image_roi[None], template[None])[0, 0, 0]
