"""Shi-Tomasi corners with non-max suppression, and spatial suppression of
candidates near tracked landmarks.

Port of ``surikatoko_tpu/vision/features.py``. Every filter is separable and
written as shifted-slice adds/maxes in the reference's order of summation;
the response is computed in float32 whatever the image's dtype, as in the
reference, so float64 callers pick the same corners. The top-N runs over
per-tile (4x4) maxima: NMS survivors are more than ``nms_radius`` apart, so
for nms_radius >= tile - 1 a tile holds at most one and the reduction is
exact, up to ties between equal responses inside a radius.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _sep_filter(img: torch.Tensor, kv, kh) -> torch.Tensor:
    """Separable zero-padded 'SAME' filter: vertical taps kv, then
    horizontal taps kh (odd-length lists of Python floats)."""
    H, W = img.shape
    rv = (len(kv) - 1) // 2
    p = F.pad(img, (0, 0, rv, rv))
    v = sum(float(k) * p[i:i + H] for i, k in enumerate(kv) if k != 0.0)
    rh = (len(kh) - 1) // 2
    p = F.pad(v, (rh, rh, 0, 0))
    return sum(float(k) * p[:, j:j + W] for j, k in enumerate(kh) if k != 0.0)


def _sep_maxpool(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 window max with -inf padding, as two separable passes."""
    H, W = x.shape
    p = F.pad(x, (0, 0, radius, radius), value=-torch.inf)
    v = functools.reduce(torch.maximum,
                         (p[i:i + H] for i in range(2 * radius + 1)))
    p = F.pad(v, (radius, radius, 0, 0), value=-torch.inf)
    return functools.reduce(torch.maximum,
                            (p[:, j:j + W] for j in range(2 * radius + 1)))


def shi_tomasi_response(image: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Min-eigenvalue corner response of the structure tensor (float32)."""
    img = image.to(torch.float32)
    gx = _sep_filter(img, (0.125, 0.25, 0.125), (-1.0, 0.0, 1.0))
    gy = _sep_filter(img, (-1.0, 0.0, 1.0), (0.125, 0.25, 0.125))
    ones = (1.0,) * window
    a = _sep_filter(gx * gx, ones, ones)
    b = _sep_filter(gx * gy, ones, ones)
    c = _sep_filter(gy * gy, ones, ones)
    tr = a + c
    det_rad = torch.sqrt(torch.clamp((a - c) ** 2 + 4 * b * b, min=0.0))
    return 0.5 * (tr - det_rad)


def detect_corners(image: torch.Tensor, max_corners: int = 50,
                   nms_radius: int = 5, border: int = 10,
                   quality_level: float = 0.01, tile: int = 4
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-N Shi-Tomasi corners. Returns (xy [N,2] float32, valid [N])."""
    if nms_radius < tile - 1:
        raise ValueError(f"nms_radius {nms_radius} < tile - 1 = {tile - 1}: "
                         "the per-tile reduction would drop corners")
    H, W = image.shape
    dev = image.device
    resp = shi_tomasi_response(image)
    is_peak = (resp >= _sep_maxpool(resp, nms_radius)) & (resp > 0)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inside = ((xs >= border) & (xs < W - border)
              & (ys >= border) & (ys < H - border))
    thresh = quality_level * resp.max()
    score = torch.where(is_peak & inside & (resp >= thresh), resp, -torch.inf)

    Hp = -(-H // tile) * tile
    Wp = -(-W // tile) * tile
    sp = F.pad(score, (0, Wp - W, 0, Hp - H), value=-torch.inf)
    nty, ntx = Hp // tile, Wp // tile
    tiles = sp.reshape(nty, tile, ntx, tile).permute(0, 2, 1, 3)
    tiles = tiles.reshape(nty * ntx, tile * tile)
    tile_arg = torch.argmax(tiles, dim=1)
    tile_max = torch.take_along_dim(tiles, tile_arg[:, None], dim=1)[:, 0]

    top_vals, top_i = torch.topk(tile_max, max_corners)
    inner = tile_arg[top_i]
    y = (top_i // ntx) * tile + inner // tile
    x = (top_i % ntx) * tile + inner % tile
    xy = torch.stack([x, y], dim=1).to(torch.float32)
    return xy, torch.isfinite(top_vals)


def filter_out_closest(candidates: torch.Tensor, cand_valid: torch.Tensor,
                       existing: torch.Tensor, exist_valid: torch.Tensor,
                       min_dist: float) -> torch.Tensor:
    """Drop candidates within ``min_dist`` of a valid existing point
    (reference FilterOutClosest, demo-davison-mono-slam.cpp:828)."""
    d2 = torch.sum((candidates[:, None, :] - existing[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(exist_valid[None, :], d2, torch.inf)
    return cand_valid & (d2.min(dim=1).values >= min_dist**2)
