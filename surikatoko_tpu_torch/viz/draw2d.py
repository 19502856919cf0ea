"""2D camera-view overlays: projected landmarks, uncertainty ellipses, axes.

Port of ``surikatoko_tpu/viz/draw2d.py`` (the reference's
DavisonMonoSlam2DDrawer, demo-davison-mono-slam-ui.h:164, and
Draw2DProjectedAxes, demos/visualize-helpers.cpp). Renders onto an RGB
numpy image (no OpenCV); demos save the frames as PNGs or pass them to
matplotlib.
"""

from __future__ import annotations

import numpy as np

from surikatoko_tpu_torch.geom.ellipse import RotatedEllipse2D
from surikatoko_tpu_torch.io.checkpoint import _host as np_


def _clip_int(v, lo, hi):
    return int(min(max(v, lo), hi))


def draw_cross(img: np.ndarray, xy, color=(0, 255, 0), size: int = 3) -> None:
    H, W = img.shape[:2]
    x, y = int(round(float(xy[0]))), int(round(float(xy[1])))
    if not (0 <= x < W and 0 <= y < H):
        return
    img[y, _clip_int(x - size, 0, W - 1):_clip_int(x + size + 1, 0, W)] = color
    img[_clip_int(y - size, 0, H - 1):_clip_int(y + size + 1, 0, H), x] = color


def draw_ellipse(img: np.ndarray, e: RotatedEllipse2D,
                 color=(255, 128, 0), n: int = 64) -> None:
    H, W = img.shape[:2]
    t = np.linspace(0, 2 * np.pi, n)
    semi = np_(e.semi_axes)
    local = np.stack([semi[0] * np.cos(t), semi[1] * np.sin(t)], axis=1)
    pts = local @ np_(e.R).T + np_(e.center)
    for x, y in pts:
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            img[yi, xi] = color


def draw_projected_axes(img: np.ndarray, project_fn, axis_len: float = 0.5
                        ) -> None:
    """World-origin axes overlay (reference Draw2DProjectedAxes): project_fn
    maps a 3D point to homogeneous image coords."""
    H, W = img.shape[:2]
    origin = np.zeros(3)
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]
    o = np_(project_fn(origin))
    o2 = o[:2] / o[2]
    for axis, color in zip(np.eye(3) * axis_len, colors):
        p = np_(project_fn(axis))
        p2 = p[:2] / p[2]
        for s in np.linspace(0, 1, 50):
            q = o2 * (1 - s) + p2 * s
            xi, yi = int(round(q[0])), int(round(q[1]))
            if 0 <= xi < W and 0 <= yi < H:
                img[yi, xi] = color


def gray_to_rgb(gray: np.ndarray) -> np.ndarray:
    gray = np_(gray)
    return np.stack([gray, gray, gray], axis=-1).astype(np.uint8)
