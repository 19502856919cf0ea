"""Synthetic worlds: grid point clouds and the camera paths of the virtual
scenarios (rectangle, oscillation, yaw sweep, look-at list, circle), and the
GT initial camera motion.

Port of ``surikatoko_tpu/world/scene_gen.py`` (reference
virt-world/scene-generator.cpp). Setup-time host code: these functions work in
float64 on the CPU; callers cast and move the result.
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
                         z_ascent: float = 0.0, noise_std: float = 0.0,
                         rng: np.random.Generator | None = None
                         ) -> torch.Tensor:
    """Grid world with a cosine z-bump across x (reference
    GenerateWorldPoints, demo-davison-mono-slam.cpp:133-169). [N,3] f64;
    with ``noise_std`` > 0 and ``rng`` each point moves by a normal draw of
    3, point after point (the JAX package's draws)."""
    gap = 1e-8
    xs = np.arange(wb.x_min, wb.x_max + gap, cell_size[0])
    ys = np.arange(wb.y_min, wb.y_max + gap, cell_size[1])
    zs = np.arange(wb.z_min, wb.z_max + gap, cell_size[2])
    xmid = (wb.x_min + wb.x_max) / 2
    xlen = wb.x_max - wb.x_min
    pts = np.stack([
        np.array([gx, gy, gz + np.cos((gx - xmid) / xlen * np.pi) * z_ascent])
        for gz in zs for gy in ys for gx in xs])
    if noise_std > 0 and rng is not None:
        pts = pts + np.stack([rng.normal(scale=noise_std, size=3)
                              for _ in range(len(pts))])
    return torch.as_tensor(pts, dtype=torch.float64)


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _look_at_cfw(eyes, centers, ups) -> SE3:
    """Batched cfw poses of cameras at ``eyes`` looking at ``centers``."""
    eyes = np.asarray(eyes, float)
    return se3.look_at_luf_wfc(
        _f64(eyes), _f64(np.broadcast_to(centers, eyes.shape)),
        _f64(np.broadcast_to(ups, eyes.shape))).inv()


def rectangular_path(wb: WorldBounds, steps_per_side_x: int,
                     steps_per_side_y: int, eye_offset, center_offset,
                     up) -> SE3:
    """Camera walks the perimeter of the world rectangle at z_min, eye and
    center offset from the perimeter point (reference
    demo-davison-mono-slam.cpp:84). Batched cfw poses."""
    base = np.array([[wb.x_min, wb.y_min, wb.z_min],
                     [wb.x_max, wb.y_min, wb.z_min],
                     [wb.x_max, wb.y_max, wb.z_min],
                     [wb.x_min, wb.y_max, wb.z_min],
                     [wb.x_min, wb.y_min, wb.z_min]])
    steps = [steps_per_side_x, steps_per_side_y, steps_per_side_x,
             steps_per_side_y]
    # the last point of a side is the first of the next
    cur = np.concatenate([
        base[seg] + (base[seg + 1] - base[seg]) / steps[seg] * i
        for seg in range(4) for i in range(steps[seg])]).reshape(-1, 3)
    return _look_at_cfw(cur + np.asarray(eye_offset, float),
                        cur + np.asarray(center_offset, float),
                        np.asarray(up, float))


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
    return _look_at_cfw(cur_eye, cur_center, upn)


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
    return _look_at_cfw(eye, cc, [0.0, 0.0, 1.0])


def rotate_left_and_right(eye, up, min_ang: float, max_ang: float,
                          periods_count: int, shots_per_period: int) -> SE3:
    """Camera fixed at ``eye``, yawing sinusoidally between the two angles
    (reference scene-generator.cpp:137-167). Batched cfw poses."""
    eye = np.asarray(eye, float)
    i = np.arange(periods_count * shots_per_period)
    ang = ((min_ang + max_ang) / 2
           + np.sin(2 * np.pi / shots_per_period * i) * (max_ang - min_ang) / 2)
    view = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], axis=-1)
    eyes = np.broadcast_to(eye, view.shape)
    return _look_at_cfw(eyes, eyes + view, np.asarray(up, float))


def look_at_path(cam_poses: list[tuple], periods_count: int = 1) -> SE3:
    """Custom path from (eye, center, up) triples, repeated
    ``periods_count`` times (reference :168). Batched cfw poses."""
    eyes, centers, ups = (np.asarray([p[j] for p in cam_poses] * periods_count,
                                     float).reshape(-1, 3) for j in range(3))
    return _look_at_cfw(eyes, centers, ups)


def initial_camera_motion(cfw0: SE3, cfw1: SE3, dt: float = 1.0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """GT initial (linear velocity in the tracker frame, angular velocity in
    the camera frame) from the first two poses (reference
    GetSyntheticCameraInitialMovement, demo-davison-mono-slam.cpp:171-200)."""
    from surikatoko_tpu_torch.geom import so3
    wfc0, wfc1 = cfw0.inv(), cfw1.inv()
    vel_tracker = (cfw0.R @ (wfc1.t - wfc0.t)) / dt
    ang_vel = so3.log(se3.a_from_b(cfw0, cfw1).R) / dt
    return vel_tracker, ang_vel
