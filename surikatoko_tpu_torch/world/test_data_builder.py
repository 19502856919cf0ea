"""Synthetic datasets for tests and demos: named worlds of (points [N,3],
camera poses cfw [F], K) with deterministic geometry, and their pixel
observations.

Port of ``surikatoko_tpu/world/test_data_builder.py`` (the reference
prototype's test_data_builder.py: ``CrystallGridDataSet`` :26,
``CircusGridDataSet`` :240). Points and K are numpy float64 arrays, as in
the JAX package; the poses are a batched SE3 on ``device`` (the card by
default) in ``dtype`` (default ``config.default_dtype(device)``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.world import scene_gen

_K = np.array([[520.0, 0, 160.0], [0, 520.0, 120.0], [0, 0, 1.0]])


class DataSet(NamedTuple):
    points: np.ndarray   # [N,3]
    cfw: SE3             # [F] camera-from-world
    K: np.ndarray        # [3,3]


def _on(cfw: SE3, dtype, device) -> SE3:
    dtype = dtype or config.default_dtype(device)
    return SE3(cfw.R.to(dtype=dtype, device=device),
               cfw.t.to(dtype=dtype, device=device))


def crystall_grid_dataset(n_frames: int = 10, cell: float = 0.5,
                          half_extent: float = 1.5,
                          dtype: torch.dtype | None = None,
                          device: torch.device | str = "cuda") -> DataSet:
    """3D lattice of points ("crystal grid") viewed from a straight sweep."""
    wb = scene_gen.WorldBounds(-half_extent, half_extent,
                               -half_extent, half_extent, 0.0, 1.0)
    points = scene_gen.generate_grid_points(wb, (cell, cell, cell)).numpy()
    eyes = [[-1.0 + 2.0 * i / max(n_frames - 1, 1), -4.0, 1.5]
            for i in range(n_frames)]
    cfw = scene_gen.look_at_path([(e, [0.0, 0.0, 0.5], [0.0, 0.0, 1.0])
                                  for e in eyes])
    return DataSet(points=points, cfw=_on(cfw, dtype, device), K=_K.copy())


def circus_grid_dataset(n_frames: int = 12, radius: float = 4.0,
                        dtype: torch.dtype | None = None,
                        device: torch.device | str = "cuda") -> DataSet:
    """Grid world circled by the camera ("circus ring")."""
    wb = scene_gen.WorldBounds(-1.5, 1.5, -1.5, 1.5, 0.0, 0.5)
    points = scene_gen.generate_grid_points(wb, (0.5, 0.5, 0.5)).numpy()
    angles = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    cfw = scene_gen.circle_camera_shots((0.0, 0.0, 0.25), radius, 2.5, angles)
    return DataSet(points=points, cfw=_on(cfw, dtype, device), K=_K.copy())


def project_dataset(ds: DataSet, noise_pix: float = 0.0, seed: int = 0,
                    image_size=(320, 240)) -> tuple[np.ndarray, np.ndarray]:
    """(obs [N,F,2], mask [N,F]) pixel observations of a dataset, on the
    host in float64; noise from ``default_rng(seed)`` frame by frame."""
    rng = np.random.default_rng(seed)
    R_all = ds.cfw.R.detach().cpu().double().numpy()
    t_all = ds.cfw.t.detach().cpu().double().numpy()
    N, F = len(ds.points), t_all.shape[0]
    obs = np.zeros((N, F, 2))
    mask = np.zeros((N, F), bool)
    W, H = image_size
    for f in range(F):
        xc = ds.points @ R_all[f].T + t_all[f]
        vis = xc[:, 2] > 0.1
        ph = xc @ ds.K.T
        pix = ph[:, :2] / ph[:, 2:3]
        if noise_pix:
            pix = pix + rng.normal(scale=noise_pix, size=pix.shape)
        obs[:, f] = pix
        mask[:, f] = (vis & (pix[:, 0] >= 0) & (pix[:, 0] < W)
                      & (pix[:, 1] >= 0) & (pix[:, 1] < H))
    return obs, mask
