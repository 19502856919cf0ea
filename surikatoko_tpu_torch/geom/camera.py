"""Pinhole camera with Mikhail radial distortion.

Port of ``surikatoko_tpu/geom/camera.py``; conventions of the reference
(davison-mono-slam.cpp):
* projection (:3007): hu = [Cx - fx X/Z, Cy - fy Y/Z] (Left-Up-Forward frame);
* backprojection (:2418): hc = [-(u - Cx)/fx, -(v - Cy)/fy, 1];
* Mikhail distortion (:2960): ru = rd + k1 rd^3 + k2 rd^5 in mm, distorted
  pixel hd = C + (hu - C)/stretch, stretch = 1 + k1 rd^2 + k2 rd^4;
* azimuth/elevation (:399): theta = atan2(x, z), phi = atan2(-y, |(x, z)|).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from surikatoko_tpu_torch import config


class CameraIntrinsics(NamedTuple):
    image_size: torch.Tensor          # [2] (width, height) pixels
    principal_point: torch.Tensor     # [2] (Cx, Cy) pixels
    focal_length_mm: torch.Tensor     # scalar
    pixel_size_mm: torch.Tensor       # [2] (dx, dy)

    @property
    def focal_length_pix(self) -> torch.Tensor:
        return self.focal_length_mm / self.pixel_size_mm


class MikhailDistortion(NamedTuple):
    k1: torch.Tensor
    k2: torch.Tensor


def make_intrinsics(image_size, principal_point, focal_length_mm,
                    pixel_size_mm, *, dtype: torch.dtype | None = None,
                    device: torch.device | str = "cuda") -> CameraIntrinsics:
    """On the card unless ``device`` says otherwise; ``dtype`` defaults to
    ``config.default_dtype(device)``."""
    dtype = dtype or config.default_dtype(device)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return CameraIntrinsics(image_size=t(image_size),
                            principal_point=t(principal_point),
                            focal_length_mm=t(focal_length_mm),
                            pixel_size_mm=t(pixel_size_mm))


def _radius_mm(cam: CameraIntrinsics, pix: torch.Tensor) -> torch.Tensor:
    d = (pix - cam.principal_point) * cam.pixel_size_mm
    # tiny bias keeps sqrt differentiable at the principal point
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-24)


def solve_distorted_radius(ru: torch.Tensor, k1: torch.Tensor,
                           k2: torch.Tensor, newton_iters: int = 8
                           ) -> torch.Tensor:
    """Root rd of rd + k1 rd^3 + k2 rd^5 = ru (k1, k2 >= 0) by Newton from
    the smallest of the three single-term upper bounds (monotone, converges
    in < 6 iterations for any radius)."""
    tiny = torch.as_tensor(1e-30, dtype=ru.dtype, device=ru.device)
    rd = torch.minimum(ru, (ru / torch.maximum(k1, tiny)) ** (1.0 / 3.0))
    rd = torch.minimum(rd, (ru / torch.maximum(k2, tiny)) ** (1.0 / 5.0))
    for _ in range(newton_iters):
        f = rd + k1 * rd**3 + k2 * rd**5 - ru
        fp = 1.0 + 3.0 * k1 * rd**2 + 5.0 * k2 * rd**4
        rd = rd - f / fp
    return rd


def distort_pixel(cam: CameraIntrinsics, dist: MikhailDistortion,
                  hu: torch.Tensor, newton_iters: int = 8) -> torch.Tensor:
    """Undistorted pixel hu -> distorted pixel hd."""
    ru = _radius_mm(cam, hu)
    rd = solve_distorted_radius(ru, dist.k1, dist.k2, newton_iters)
    stretch = 1.0 + dist.k1 * rd**2 + dist.k2 * rd**4
    return cam.principal_point + (hu - cam.principal_point) / stretch[..., None]


def undistort_pixel(cam: CameraIntrinsics, dist: MikhailDistortion,
                    hd: torch.Tensor) -> torch.Tensor:
    """Distorted pixel hd -> undistorted hu (closed form)."""
    rd = _radius_mm(cam, hd)
    stretch = 1.0 + dist.k1 * rd**2 + dist.k2 * rd**4
    return cam.principal_point + (hd - cam.principal_point) * stretch[..., None]


def project_camera_point(cam: CameraIntrinsics,
                         dist: MikhailDistortion | None,
                         x_cam: torch.Tensor) -> torch.Tensor:
    """3D point in camera frame -> distorted pixel (batched)."""
    f = cam.focal_length_pix
    z = x_cam[..., 2]
    hu = cam.principal_point - f * x_cam[..., :2] / z[..., None]
    if dist is None:
        return hu
    return distort_pixel(cam, dist, hu)


def backproject_pixel(cam: CameraIntrinsics, dist: MikhailDistortion | None,
                      hd: torch.Tensor) -> torch.Tensor:
    """Distorted pixel -> direction [x, y, 1] in the camera frame (A.58)."""
    hu = hd if dist is None else undistort_pixel(cam, dist, hd)
    xy = -(hu - cam.principal_point) / cam.focal_length_pix
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def azim_elev_from_dir(hw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Azimuth theta / elevation phi of a (world) direction."""
    theta = torch.atan2(hw[..., 0], hw[..., 2])
    phi = torch.atan2(-hw[..., 1], torch.sqrt(hw[..., 0] ** 2 + hw[..., 2] ** 2))
    return theta, phi


def dir_from_azim_elev(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Unit direction m(theta, phi), inverse of :func:`azim_elev_from_dir`."""
    cphi = torch.cos(phi)
    return torch.stack([cphi * torch.sin(theta), -torch.sin(phi),
                        cphi * torch.cos(theta)], dim=-1)
