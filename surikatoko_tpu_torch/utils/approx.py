"""Closeness predicates with numpy semantics (reference approx-alg.h:8-47).

Port of ``surikatoko_tpu/utils/approx.py``.
"""

from __future__ import annotations

import torch


def is_close(a, b, rtol: float = 1e-5, atol: float = 1e-8) -> torch.Tensor:
    """|a - b| <= atol + rtol |b| elementwise (``numpy.isclose``)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.isclose(a, b.to(a.dtype), rtol=rtol, atol=atol)


def is_close_abs(a, b, atol: float = 1e-8) -> torch.Tensor:
    return torch.abs(torch.as_tensor(a) - torch.as_tensor(b)) <= atol


def sqr(x):
    return x * x
