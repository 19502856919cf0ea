"""Filter-health mechanisms on the slice's path.

Port of ``surikatoko_tpu/models/monoslam/health.py``: negative inverse-depth
substitution (reference davison-mono-slam.cpp:1713-1737) and the
nonnegative-variance clamp (:1739-1756). The rest of the module (quaternion
renorm, uncertainty-ellipsoid checks, reset to GT) waits in ROADMAP queue A.
"""

from __future__ import annotations

import torch

from surikatoko_tpu_torch.models.monoslam.state import CAM_STATE_COMPS

_N = CAM_STATE_COMPS


def ensure_nonneg_variance(P: torch.Tensor) -> torch.Tensor:
    """Zero the rows/cols of any state variable with negative variance."""
    keep = (~(torch.diagonal(P) < 0)).to(P.dtype)
    return P * keep[:, None] * keep[None, :]


def substitute_negative_inv_rho(x: torch.Tensor, substitute: torch.Tensor,
                                capacity: int
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Replace negative inverse depths with ``substitute``; returns
    (x', count substituted)."""
    lms = x[_N:].reshape(capacity, 6)
    neg = lms[:, 5] < 0
    rho = torch.where(neg, substitute.to(x.dtype), lms[:, 5])
    lms = torch.cat([lms[:, :5], rho[:, None]], dim=1)
    return torch.cat([x[:_N], lms.reshape(-1)]), neg.sum(dtype=torch.int32)
