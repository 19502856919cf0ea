"""The reference's dtype default: float64 everywhere unless asked (the
reference is called with an explicit dtype by the benchmark)."""

from __future__ import annotations

import torch


def default_dtype(device: torch.device | str) -> torch.dtype:
    return torch.float64
