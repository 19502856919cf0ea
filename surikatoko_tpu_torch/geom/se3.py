"""SE(3) rigid transforms and look-at construction.

Port of ``surikatoko_tpu/geom/se3.py``. A transform maps points from frame B
to frame A: ``x_a = R @ x_b + t``; "cfw" = camera-from-world, "wfc" =
world-from-camera; the camera frame is Left-Up-Forward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from surikatoko_tpu_torch import config


class SE3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...j->...i", self.R, x) + self.t

    def inv(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -torch.einsum("...ij,...j->...i", Rt, self.t))

    def compose(self, other: "SE3") -> "SE3":
        """self o other: first apply ``other``, then ``self``."""
        return SE3(self.R @ other.R,
                   torch.einsum("...ij,...j->...i", self.R, other.t) + self.t)

    def matrix4(self) -> torch.Tensor:
        bot = torch.as_tensor([0.0, 0.0, 0.0, 1.0], dtype=self.R.dtype,
                              device=self.R.device)
        bot = bot.expand(self.R.shape[:-2] + (1, 4))
        top = torch.cat([self.R, self.t[..., None]], dim=-1)
        return torch.cat([top, bot], dim=-2)


def identity(dtype: torch.dtype | None = None, batch_shape=(), *,
             device: torch.device | str = "cuda") -> SE3:
    """Identity transforms of ``batch_shape``. On the card unless ``device``
    says otherwise; ``dtype`` defaults to ``config.default_dtype(device)``."""
    dtype = dtype or config.default_dtype(device)
    eye = torch.eye(3, dtype=dtype, device=device)
    return SE3(eye.expand(tuple(batch_shape) + (3, 3)).clone(),
               torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device))


def a_from_b(a_from_w: SE3, b_from_w: SE3) -> SE3:
    """Transform mapping frame B coordinates into frame A (reference
    SE3AFromB)."""
    return a_from_w.compose(b_from_w.inv())


def look_at_luf_wfc(eye: torch.Tensor, center: torch.Tensor,
                    up: torch.Tensor) -> SE3:
    """World-from-camera for a camera at `eye` looking at `center`: col2 =
    forward, col1 = up component orthogonal to forward, col0 = up x forward
    (reference obs-geom.cpp:729-749)."""
    fwd = center - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    cam_up = up - fwd * torch.sum(up * fwd, dim=-1, keepdim=True)
    cam_up = cam_up / torch.linalg.norm(cam_up, dim=-1, keepdim=True)
    left = torch.linalg.cross(cam_up, fwd, dim=-1)
    R = torch.stack([left, cam_up, fwd], dim=-1)
    return SE3(R, eye)
