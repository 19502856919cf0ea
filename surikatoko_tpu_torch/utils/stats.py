"""Streaming mean/std accumulator (reference stat-helpers.h:7-18).

Port of ``surikatoko_tpu/utils/stats.py``: the state is a small tuple of
tensors (Welford's update), so it lives on the device with the values it
accumulates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from surikatoko_tpu_torch import config


class MeanStdState(NamedTuple):
    n: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor  # sum of squared deviations (Welford)


def mean_std_init(dtype: torch.dtype | None = None,
                  device: torch.device | str = "cuda") -> MeanStdState:
    dtype = dtype or config.default_dtype(device)
    z = torch.zeros((), dtype=dtype, device=device)
    return MeanStdState(torch.zeros((), dtype=torch.int32, device=device), z, z)


def mean_std_update(s: MeanStdState, x) -> MeanStdState:
    x = torch.as_tensor(x, dtype=s.mean.dtype, device=s.mean.device)
    n = s.n + 1
    delta = x - s.mean
    mean = s.mean + delta / n
    m2 = s.m2 + delta * (x - mean)
    return MeanStdState(n, mean, m2)


def mean_std_result(s: MeanStdState) -> tuple[torch.Tensor, torch.Tensor]:
    var = torch.where(s.n > 1, s.m2 / torch.clamp(s.n - 1, min=1), 0.0)
    return s.mean, torch.sqrt(var)
