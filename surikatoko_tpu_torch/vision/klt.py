"""Pyramidal Lucas-Kanade point tracking.

Port of ``surikatoko_tpu/vision/klt.py`` (the reference prototype tracks
corners with cv2.calcOpticalFlowPyrLK, py_proto/suriko/mvg.py:2066, :3331):
a Gaussian pyramid by a separable 5-tap blur with 2x decimation, then per
level a fixed number of Gauss-Newton steps on a (2w+1)^2 window, all points
at once, with bilinear gathers. Everything runs in float32 with fixed
shapes: the iteration count is fixed, nothing reads the card.

The decimating blur reproduces XLA's "SAME" padding with stride 2, which is
asymmetric at an even size (240 rows: 1 above, 2 below). The bilinear
sample clamps to [0, W - 1.001] with explicit gathers, as the JAX package
does (``grid_sample`` has other corner conventions).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

_GAUSS5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _same_pad(n: int, k: int = 5, stride: int = 2) -> tuple[int, int, int]:
    """(output size, padding before, padding after) of XLA's "SAME"."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return out, total // 2, total - total // 2


def _blur_downsample(img: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur with 2x decimation, rows then columns."""
    H, W = img.shape
    oh, lo, hi = _same_pad(H)
    p = F.pad(img, (0, 0, lo, hi))
    x = sum(k * p[i:i + 2 * oh - 1:2] for i, k in enumerate(_GAUSS5))
    ow, lo, hi = _same_pad(W)
    p = F.pad(x, (lo, hi, 0, 0))
    return sum(k * p[:, j:j + 2 * ow - 1:2] for j, k in enumerate(_GAUSS5))


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[level 0 = full resolution, ..., level L-1 = coarsest], float32."""
    pyr = [img.to(torch.float32)]
    for _ in range(levels - 1):
        pyr.append(_blur_downsample(pyr[-1]))
    return pyr


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img`` at float (x, y), clamped to the border."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


class KltResult(NamedTuple):
    points: torch.Tensor   # [K, 2] tracked (x, y) in img1
    status: torch.Tensor   # [K] bool: well-conditioned and in bounds
    error: torch.Tensor    # [K] mean |I1 - I0| over the window at the solution


def _track_level(img0, img1, pts0_lvl, d, win: int, iters: int, min_det: float):
    """One pyramid level: refine the flow d [K,2] of the points pts0_lvl
    [K,2]. Returns (d, ok [K], err [K])."""
    r = torch.arange(-win, win + 1, dtype=img0.dtype, device=img0.device)
    uy, ux = torch.meshgrid(r, r, indexing="ij")
    px = pts0_lvl[:, 0:1] + ux.reshape(1, -1)          # [K, n]
    py = pts0_lvl[:, 1:2] + uy.reshape(1, -1)
    i0 = _bilinear(img0, px, py)
    gx = 0.5 * (_bilinear(img0, px + 1, py) - _bilinear(img0, px - 1, py))
    gy = 0.5 * (_bilinear(img0, px, py + 1) - _bilinear(img0, px, py - 1))
    gxx = torch.sum(gx * gx, dim=1)
    gxy = torch.sum(gx * gy, dim=1)
    gyy = torch.sum(gy * gy, dim=1)
    det = gxx * gyy - gxy * gxy
    ok = det > min_det
    det_safe = torch.where(ok, det, 1.0)
    for _ in range(iters):
        e = _bilinear(img1, px + d[:, 0:1], py + d[:, 1:2]) - i0
        bx = torch.sum(e * gx, dim=1)
        by = torch.sum(e * gy, dim=1)
        ddx = -(gyy * bx - gxy * by) / det_safe
        ddy = -(-gxy * bx + gxx * by) / det_safe
        d = d + torch.where(ok[:, None], torch.stack([ddx, ddy], dim=1), 0.0)
    err = torch.mean(torch.abs(_bilinear(img1, px + d[:, 0:1], py + d[:, 1:2])
                               - i0), dim=1)
    return d, ok, err


def track_points(img0: torch.Tensor, img1: torch.Tensor, pts0: torch.Tensor,
                 valid: torch.Tensor | None = None, *,
                 levels: int = 3, win: int = 7, iters: int = 10,
                 min_det: float = 1e-4, max_error: float = 20.0) -> KltResult:
    """Track pts0 [K,2] (x, y) from img0 to img1 (grayscale [H,W]),
    coarse to fine over ``levels``; the pull-in range is roughly
    win * 2**(levels-1) pixels of true displacement."""
    img0 = img0.to(torch.float32)
    img1 = img1.to(torch.float32)
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)
    pts = pts0.to(torch.float32)
    K = pts.shape[0]
    d = torch.zeros((K, 2), dtype=torch.float32, device=pts.device)
    ok_all = torch.ones(K, dtype=torch.bool, device=pts.device)
    err = torch.zeros(K, dtype=torch.float32, device=pts.device)
    for lvl in range(levels - 1, -1, -1):
        scale = float(2.0 ** lvl)
        d, ok, err = _track_level(pyr0[lvl], pyr1[lvl], pts / scale, d,
                                  win, iters, min_det)
        ok_all = ok_all & ok
        if lvl > 0:
            d = d * 2.0
    new_pts = pts + d
    H, W = img1.shape
    in_bounds = ((new_pts[:, 0] >= win) & (new_pts[:, 0] <= W - 1 - win)
                 & (new_pts[:, 1] >= win) & (new_pts[:, 1] <= H - 1 - win))
    status = ok_all & in_bounds & (err < max_error)
    if valid is not None:
        status = status & valid
    return KltResult(points=new_pts, status=status, error=err)
