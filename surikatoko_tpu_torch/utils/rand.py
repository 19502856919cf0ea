"""Sampling from covariance matrices and Monte-Carlo uncertainty propagation.

Port of ``surikatoko_tpu/utils/rand.py`` (reference rand-stuff.h:19-130):
white noise through the covariance eigenbasis, the sample covariance, and
propagation through a nonlinear function by simulation, the cross-check of
the first-order propagation with ``torch.func.jacfwd`` Jacobians. The white
noise comes from the caller: a ``torch.Generator``, or the draws
themselves (``white`` [n, d]).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd, vmap


def sample_from_covariance(mean: torch.Tensor, cov: torch.Tensor,
                           n: int | None = None, *,
                           generator: torch.Generator | None = None,
                           white: torch.Tensor | None = None) -> torch.Tensor:
    """n samples ~ N(mean, cov) through the symmetric eigenbasis: the
    standard normal draws ``white`` [n, d], or n of them drawn from
    ``generator``."""
    if white is None:
        if generator is None or n is None:
            raise ValueError("pass white draws, or a generator and n")
        white = torch.randn((n, mean.shape[-1]), generator=generator,
                            dtype=mean.dtype, device=generator.device)
    vals, vecs = torch.linalg.eigh(cov)
    scale = torch.sqrt(torch.clamp(vals, min=0.0))
    return mean + (white.to(mean.device, mean.dtype) * scale) @ vecs.T


def calc_covar_mat(samples: torch.Tensor) -> torch.Tensor:
    """Sample covariance of rows (reference CalcCovarMat, rand-stuff.h:49)."""
    centered = samples - samples.mean(dim=0)
    return centered.T @ centered / (samples.shape[0] - 1)


def propagate_uncertainty_mc(
    fn: Callable[[torch.Tensor], torch.Tensor],
    mean: torch.Tensor, cov: torch.Tensor, n: int = 10_000, *,
    generator: torch.Generator | None = None,
    white: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo (E[f(x)], Cov[f(x)]) for x ~ N(mean, cov) (reference
    PropagateUncertaintyUsingSimulation, rand-stuff.h:96-130); ``fn`` maps
    one [d] point and is vmapped over the samples."""
    xs = sample_from_covariance(mean, cov, n, generator=generator, white=white)
    ys = vmap(fn)(xs)
    return ys.mean(dim=0), calc_covar_mat(ys)


def propagate_uncertainty_jacobian(
    fn: Callable[[torch.Tensor], torch.Tensor],
    mean: torch.Tensor, cov: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """First-order propagation: (f(mean), J cov J^T) with J = jacfwd(fn)."""
    J = jacfwd(fn)(mean)
    return fn(mean), J @ cov @ J.T
