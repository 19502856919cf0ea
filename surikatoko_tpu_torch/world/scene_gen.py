"""Synthetic worlds: grid point clouds, the oscillating camera path and the
circle of cameras.

Port of the slice's part of ``surikatoko_tpu/world/scene_gen.py`` (reference
virt-world/scene-generator.cpp). Setup-time host code: it builds in float64
on the CPU; callers cast and move the result.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surikatoko_tpu_torch.geom import se3
from surikatoko_tpu_torch.geom.se3 import SE3


class WorldBounds(NamedTuple):
    x_min: float
    x_max: float
    y_min: float
    y_max: float
    z_min: float
    z_max: float


def generate_grid_points(wb: WorldBounds,
                         cell_size: tuple[float, float, float],
                         z_ascent: float = 0.0) -> torch.Tensor:
    """Grid world with a cosine z-bump across x (reference
    GenerateWorldPoints, demo-davison-mono-slam.cpp:133-169). [N,3] f64."""
    gap = 1e-8
    xs = np.arange(wb.x_min, wb.x_max + gap, cell_size[0])
    ys = np.arange(wb.y_min, wb.y_max + gap, cell_size[1])
    zs = np.arange(wb.z_min, wb.z_max + gap, cell_size[2])
    xmid = (wb.x_min + wb.x_max) / 2
    xlen = wb.x_max - wb.x_min
    pts = [np.array([gx, gy, gz + np.cos((gx - xmid) / xlen * np.pi) * z_ascent])
           for gz in zs for gy in ys for gx in xs]
    return torch.as_tensor(np.stack(pts), dtype=torch.float64)


def oscillate_right_and_left(eye, center, up, max_deviation: float,
                             periods_count: int, shots_per_period: int,
                             const_view_dir: bool = True) -> SE3:
    """Camera slides sinusoidally along the axis orthogonal to the view
    direction (reference scene-generator.cpp:98-136). Batched cfw poses."""
    eye = np.asarray(eye, float)
    center = np.asarray(center, float)
    upn = np.asarray(up, float)
    view = center - eye
    view = view / np.linalg.norm(view)
    right = np.cross(view, upn)
    right = right / np.linalg.norm(right)
    i = np.arange(periods_count * shots_per_period)
    dev = np.sin(2 * np.pi / shots_per_period * i) * max_deviation
    cur_eye = eye + dev[:, None] * right
    cur_center = cur_eye + view if const_view_dir else np.broadcast_to(
        center, cur_eye.shape)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    wfc = se3.look_at_luf_wfc(t(cur_eye), t(cur_center),
                              t(np.broadcast_to(upn, cur_eye.shape)))
    return wfc.inv()


def circle_camera_shots(circle_center, circle_radius: float, ascent_z: float,
                        rot_angles) -> SE3:
    """Cameras on a circle ``ascent_z`` above ``circle_center``, each looking
    at the center (reference scene-generator.cpp:9-56). Used by the BA
    circle-grid fixture. Batched cfw poses."""
    cc = np.asarray(circle_center, float)
    ang = np.asarray(rot_angles, float)
    eye = cc + np.stack([circle_radius * np.cos(ang),
                         circle_radius * np.sin(ang),
                         np.full_like(ang, ascent_z)], axis=-1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    wfc = se3.look_at_luf_wfc(t(eye), t(np.broadcast_to(cc, eye.shape)),
                              t(np.broadcast_to([0.0, 0.0, 1.0], eye.shape)))
    return wfc.inv()
