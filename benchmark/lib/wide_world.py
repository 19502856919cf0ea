"""The image loop's world, built on the host from the seed: the "wide"
strip of distinct splat points that the oscillating camera sweeps past,
and the smooth background every frame is rendered over.

A copy, in numpy, of the port's ``world/device_runner.
build_oscillating_scenario(world="wide")`` and ``build_imageseq_scenario``
(its ``bg_cell`` background), over ``lib/world.py``'s grid and path, so
that the yardstick does not move with the program. Unlike those builders,
the points and the background are drawn from the benchmark's seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from benchmark.lib import world as world_mod


class ImageWorld(NamedTuple):
    gt_cfw_R: np.ndarray      # [F,3,3] GT camera-from-tracker
    gt_cfw_t: np.ndarray      # [F,3]
    points: np.ndarray        # [N,3] tracker-frame splat points
    background: np.ndarray    # [H,W] float32 static texture
    splat_amp: float          # blob peak intensity
    splat_sigma: float        # blob gaussian sigma (pixels)


def smooth_background(rng, width: int, height: int, cell: int,
                      lo: float, hi: float) -> np.ndarray:
    """[H,W] float32: a grid of uniform(lo, hi) values every ``cell``
    pixels, bilinearly upsampled."""
    gh, gw = height // cell + 2, width // cell + 2
    g = rng.uniform(lo, hi, (gh, gw))
    ys = np.arange(height) / cell
    xs = np.arange(width) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    return (g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0][:, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1][:, x0] * fy * (1 - fx)
            + g[y0 + 1][:, x0 + 1] * fy * fx).astype(np.float32)


def wide_points(rng, center, n: int, halfwidth: float, depth, height
                ) -> np.ndarray:
    """[n,3] world points: x uniform within ``halfwidth`` of the centre's,
    depth (y) and height (z) uniform over their ranges, drawn in that
    order."""
    return np.stack([rng.uniform(center[0] - halfwidth,
                                 center[0] + halfwidth, n),
                     rng.uniform(*depth, n), rng.uniform(*height, n)], axis=1)


def build(cfg: dict, seed: int) -> ImageWorld:
    """The world of configuration ``cfg`` (its "world", "path" and
    "camera" groups) from ``seed``: ``world["points"]`` distinct points
    about the grid's centre, the camera path of ``lib/world``, the
    background."""
    w, p = cfg["world"], cfg["path"]
    r_points, _, r_bg = world_mod.seeds(seed, 3)
    grid = world_mod.grid_points(w["bounds"], w["cell_size"], w["z_ascent"])
    center = grid.mean(axis=0)
    pts_w = wide_points(r_points, center, w["points"], w["halfwidth"],
                        w["depth"], w["height"])
    R, t = world_mod.oscillating_path(
        center + np.asarray(p["eye_offset"], float), center, p["up"],
        p["max_deviation"], p["periods"], p["shots_per_period"])
    pts = pts_w @ R[0].T + t[0]
    R, t = world_mod.in_tracker_frame(R, t)
    W, H = cfg["camera"]["image_size"]
    bg = smooth_background(r_bg, W, H, w["bg_cell"], *w["background"])
    return ImageWorld(R, t, pts, bg, float(w["splat_amp"]),
                      float(w["splat_sigma"]))
