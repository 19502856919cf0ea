"""SE(3) rigid transforms and look-at construction.

Port of ``surikatoko_tpu/geom/se3.py``. A transform maps points from frame B
to frame A: ``x_a = R @ x_b + t``; "cfw" = camera-from-world, "wfc" =
world-from-camera; the camera frame is Left-Up-Forward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SE3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]

    def inv(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -torch.einsum("...ij,...j->...i", Rt, self.t))


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
