"""The worlds the cells run in, built on the host in float64 from the seed:
the oscillating camera path (the reference's OscilateRightAndLeft) and the
corner grid replicated and jittered up to capacity.

A copy of the port's ``world/device_runner.build_oscillating_scenario``
with the ``world/scene_gen`` and ``geom/se3`` pieces it uses, in numpy, so
that the yardstick does not move with the program. Unlike that builder,
every random draw here comes from the benchmark's seed (jitter, detection
noise).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class World(NamedTuple):
    gt_cfw_R: np.ndarray      # [F,3,3] GT camera-from-tracker
    gt_cfw_t: np.ndarray      # [F,3]
    points: np.ndarray        # [N,3] tracker-frame points
    image_size: tuple         # (W, H)


def seeds(seed: int, n: int) -> list:
    """``n`` independent numpy generators from one seed (any size)."""
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(int(seed)).spawn(n)]


def grid_points(bounds, cell, z_ascent: float) -> np.ndarray:
    """The reference's corner grid with a cosine z-bump across x
    (scene_gen.generate_grid_points)."""
    (x0, x1), (y0, y1), (z0, z1) = bounds
    gap = 1e-8
    xs = np.arange(x0, x1 + gap, cell[0])
    ys = np.arange(y0, y1 + gap, cell[1])
    zs = np.arange(z0, z1 + gap, cell[2])
    xmid, xlen = (x0 + x1) / 2, x1 - x0
    return np.stack([
        np.array([gx, gy, gz + np.cos((gx - xmid) / xlen * np.pi) * z_ascent])
        for gz in zs for gy in ys for gx in xs])


def _look_at_cfw(eyes: np.ndarray, centers: np.ndarray, up: np.ndarray):
    """Camera-from-world (R, t) of cameras at ``eyes`` looking at
    ``centers`` (geom.se3.look_at_luf_wfc, inverted)."""
    fwd = centers - eyes
    fwd = fwd / np.linalg.norm(fwd, axis=-1, keepdims=True)
    up = np.broadcast_to(up, eyes.shape)
    cam_up = up - fwd * np.sum(up * fwd, axis=-1, keepdims=True)
    cam_up = cam_up / np.linalg.norm(cam_up, axis=-1, keepdims=True)
    left = np.cross(cam_up, fwd)
    wfc_R = np.stack([left, cam_up, fwd], axis=-1)
    R = np.swapaxes(wfc_R, -1, -2)
    return R, -np.einsum("fij,fj->fi", R, eyes)


def oscillating_path(eye, center, up, max_deviation: float,
                     periods: int, shots_per_period: int):
    """The camera slides sinusoidally across its constant view direction
    (scene_gen.oscillate_right_and_left, const_view_dir=True)."""
    eye, center, up = (np.asarray(a, float) for a in (eye, center, up))
    view = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(view, up)
    right = right / np.linalg.norm(right)
    i = np.arange(periods * shots_per_period)
    dev = np.sin(2 * np.pi / shots_per_period * i) * max_deviation
    eyes = eye + dev[:, None] * right
    return _look_at_cfw(eyes, eyes + view, up)


def in_tracker_frame(R: np.ndarray, t: np.ndarray):
    """Poses relative to the first camera, the tracker's origin
    (runner.gt_poses_in_tracker_frame)."""
    wfT_R, wfT_t = R[0].T, -R[0].T @ t[0]
    return (np.einsum("fij,jk->fik", R, wfT_R),
            np.einsum("fij,j->fi", R, wfT_t) + t)


def build(cfg: dict, seed: int) -> World:
    """The world of configuration ``cfg`` (its "world", "path" and
    "camera" groups) from ``seed``."""
    w, p = cfg["world"], cfg["path"]
    r_jitter = seeds(seed, 3)[1]      # the stream a seed's jitter always came from
    grid = grid_points(w["bounds"], w["cell_size"], w["z_ascent"])
    center = grid.mean(axis=0)
    R, t = oscillating_path(center + np.asarray(p["eye_offset"], float),
                            center, p["up"], p["max_deviation"], p["periods"],
                            p["shots_per_period"])
    pts = grid @ R[0].T + t[0]
    n_pts = cfg["capacity"]
    if len(pts) < n_pts:
        pts = np.concatenate([pts] * (n_pts // len(pts) + 1))[:n_pts]
        pts = pts + r_jitter.normal(scale=w["jitter"], size=pts.shape)
    R, t = in_tracker_frame(R, t)
    return World(R, t, pts[:n_pts], tuple(cfg["camera"]["image_size"]))


def torch_seed(seed: int) -> int:
    """A seed for ``torch.Generator`` from the benchmark's seed, apart from
    the world's draws."""
    ss = np.random.SeedSequence(int(seed)).spawn(4)[3]
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
