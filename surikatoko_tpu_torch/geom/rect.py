"""Axis-aligned rectangles as [..., 4] tensors [x, y, w, h].

Port of ``surikatoko_tpu/geom/rect.py`` (reference obs-geom.h:64-115, the
intersect/deflate/clamp helpers of the NCC search window). An empty
intersection has w <= 0 or h <= 0.
"""

from __future__ import annotations

import torch

from surikatoko_tpu_torch import config


def make(x, y, w, h, dtype: torch.dtype | None = None,
         device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.tensor([x, y, w, h], device=device,
                        dtype=dtype or config.default_dtype(device))


def from_points(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    lo = torch.minimum(p1, p2)
    hi = torch.maximum(p1, p2)
    return torch.cat([lo, hi - lo], dim=-1)


def right_bottom(r: torch.Tensor) -> torch.Tensor:
    return r[..., :2] + r[..., 2:]


def intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection rect; zero-sized (clamped) if disjoint."""
    lo = torch.maximum(a[..., :2], b[..., :2])
    hi = torch.minimum(right_bottom(a), right_bottom(b))
    return torch.cat([lo, torch.clamp(hi - lo, min=0.0)], dim=-1)


def is_empty(r: torch.Tensor) -> torch.Tensor:
    return (r[..., 2] <= 0) | (r[..., 3] <= 0)


def _pair(u, v, like: torch.Tensor) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(
        torch.as_tensor(u, dtype=like.dtype, device=like.device),
        torch.as_tensor(v, dtype=like.dtype, device=like.device)), dim=-1)


def deflate(r: torch.Tensor, dx, dy) -> torch.Tensor:
    d = _pair(dx, dy, r)
    return torch.cat([r[..., :2] + d, r[..., 2:] - 2 * d], dim=-1)


def center(r: torch.Tensor) -> torch.Tensor:
    return r[..., :2] + 0.5 * r[..., 2:]


def centered(c: torch.Tensor, w, h) -> torch.Tensor:
    wh = _pair(w, h, c)
    return torch.cat([c - 0.5 * wh, wh], dim=-1)


def contains(r: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    inside_lo = torch.all(p >= r[..., :2], dim=-1)
    inside_hi = torch.all(p < right_bottom(r), dim=-1)
    return inside_lo & inside_hi


def clamp_rect_to(outer: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Shrink r to fit inside outer (its intersection with outer)."""
    return intersect(outer, r)
