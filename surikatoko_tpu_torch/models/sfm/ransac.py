"""Batched RANSAC: every hypothesis fitted and scored in one batch.

Port of ``surikatoko_tpu/models/sfm/ransac.py`` (reference: the prototype's
sequential loop, py_proto/suriko/mvg.py:1879-1921). The JAX package draws
each minimal sample from a key and vmaps the fitter over the hypotheses;
here the caller passes the samples [M, s] or a ``torch.Generator`` to draw
them from, and the fitter and the residual take the whole batch along a
leading hypothesis axis. There is no data-dependent trip count: M is fixed.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


def ransac_iterations_count(success_prob: float, outlier_ratio: float,
                            sample_size: int) -> int:
    """Standard N = log(1-p) / log(1 - (1-eps)^s) (reference :1879)."""
    w = (1.0 - outlier_ratio) ** sample_size
    if w <= 0:
        return 10**6
    denom = np.log(max(1.0 - w, 1e-15))
    return max(1, int(np.ceil(np.log(max(1.0 - success_prob, 1e-15)) / denom)))


class RansacResult(NamedTuple):
    model: torch.Tensor         # best model parameters
    inliers: torch.Tensor       # [N] bool
    inlier_count: torch.Tensor
    best_iter: torch.Tensor


def draw_samples(generator: torch.Generator, data_size: int, sample_size: int,
                 iterations: int) -> torch.Tensor:
    """[iterations, sample_size] int64 minimal samples, each ``sample_size``
    distinct indices of ``range(data_size)`` (the first of a uniform random
    permutation), drawn on the generator's device."""
    u = torch.rand((iterations, data_size), generator=generator,
                   device=generator.device)
    return torch.argsort(u, dim=1)[:, :sample_size]


def ransac(
    data_size: int,
    sample_size: int,
    fit_fn: Callable[[torch.Tensor], torch.Tensor],
    # fit_fn(idx [M, s]) -> models [M, ...] (or [M, C, ...] candidate
    # models per hypothesis with candidates_axis=True)
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    # residual_fn(models [M, ...]) -> [M, N] squared residuals over the data
    threshold: float,
    iterations: int | None = None,
    *,
    samples: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    data_mask: torch.Tensor | None = None,
    candidates_axis: bool = False,
) -> RansacResult:
    """The model with the most inliers (squared residual < ``threshold``)
    among the hypotheses fitted to ``samples`` [M, s] (int64), or to
    ``iterations`` samples drawn from ``generator``. Ties go to the first
    hypothesis (and candidate), as ``jnp.argmax``."""
    if samples is None:
        if generator is None or iterations is None:
            raise ValueError("pass samples, or a generator and iterations")
        samples = draw_samples(generator, data_size, sample_size, iterations)
    models = fit_fn(samples)
    M = samples.shape[0]
    if candidates_axis:
        C = models.shape[1]
        res = residual_fn(models.reshape((M * C,) + models.shape[2:]))
        ok = res.reshape(M, C, -1) < threshold
        if data_mask is not None:
            ok = ok & data_mask
        counts_c = ok.sum(dim=2)                                  # [M, C]
        c = torch.argmax(counts_c, dim=1)
        models = models[torch.arange(M, device=c.device), c]
        counts = counts_c.gather(1, c[:, None])[:, 0]
    else:
        ok = residual_fn(models) < threshold
        if data_mask is not None:
            ok = ok & data_mask
        counts = ok.sum(dim=1)
    best = torch.argmax(counts)
    model = models[best]
    inliers = residual_fn(model[None])[0] < threshold
    if data_mask is not None:
        inliers = inliers & data_mask
    return RansacResult(model=model, inliers=inliers,
                        inlier_count=counts[best], best_iter=best)
