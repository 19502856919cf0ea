"""Scale-space keypoints: detection and steered BRIEF on every level of a
sqrt(2) image pyramid, reported in base-image coordinates with their scale.

Port of ``surikatoko_tpu/vision/multiscale.py``. ``jax.image.resize``'s
bilinear method antialiases when it shrinks; ``F.interpolate``'s bilinear
mode does the same with ``antialias=True``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from surikatoko_tpu_torch.ops.transfer import host
from surikatoko_tpu_torch.vision import features
from surikatoko_tpu_torch.vision.descriptors import compute_oriented_brief

SCALE_FACTOR = math.sqrt(2.0)


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize to ``out_hw`` in float32 (antialiased when shrinking)."""
    x = img.to(torch.float32)[None, None]
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def pyramid_shapes(base_hw: tuple[int, int], levels: int) -> list[tuple[int, int]]:
    H, W = base_hw
    return [(max(int(round(H / SCALE_FACTOR ** l)), 32),
             max(int(round(W / SCALE_FACTOR ** l)), 32))
            for l in range(levels)]


class ScaleSpaceKeypoints(NamedTuple):
    xy: torch.Tensor           # [N, 2] base-image coordinates
    scale: torch.Tensor        # [N] float: SCALE_FACTOR**level
    angle: torch.Tensor        # [N] orientation (radians)
    descriptors: torch.Tensor  # [N, N_WORDS] int32 packed steered BRIEF
    valid: torch.Tensor        # [N] bool


def detect_and_describe(image, *, levels: int = 4, corners_per_level: int = 24,
                        nms_radius: int = 6, border: int = 36,
                        device: torch.device | str = "cuda"
                        ) -> ScaleSpaceKeypoints:
    """Scale-space detection + description on ``device``. N = levels *
    corners_per_level slots (masked). Border is in level pixels."""
    base = torch.as_tensor(image, dtype=torch.float32, device=device)
    H, W = base.shape
    xs, ss, an, ds, vs = [], [], [], [], []
    img_l = base
    for l, hw in enumerate(pyramid_shapes((H, W), levels)):
        if l > 0:
            img_l = resize_bilinear(base, hw)
        kp, valid = features.detect_corners(
            img_l, max_corners=corners_per_level, nms_radius=nms_radius,
            border=border)
        desc, theta = compute_oriented_brief(img_l, kp, valid)
        # level coordinates back to base coordinates, per axis
        f = torch.tensor([W / hw[1], H / hw[0]], dtype=kp.dtype, device=device)
        xs.append(kp * f)
        ss.append(torch.full((corners_per_level,), SCALE_FACTOR ** l,
                             dtype=torch.float32, device=device))
        an.append(theta)
        ds.append(desc)
        vs.append(valid)
    return ScaleSpaceKeypoints(
        xy=torch.cat(xs), scale=torch.cat(ss), angle=torch.cat(an),
        descriptors=torch.cat(ds), valid=torch.cat(vs))


def similarity_consistent_matches(kp_a: ScaleSpaceKeypoints,
                                  kp_b: ScaleSpaceKeypoints,
                                  idx_b, good, *, iters: int = 128,
                                  tol: float = 4.0, seed: int = 0
                                  ) -> np.ndarray:
    """2-point RANSAC over a 2D similarity transform (scale, rotation and
    translation as one complex multiply-add): the inlier mask of the best
    model. Host numpy (match post-processing, tiny N), as in the JAX
    package."""
    good_np = host(good)
    n = int(good_np.sum())
    if n < 2:
        return good_np & False
    ga = np.nonzero(good_np)[0]
    a = host(kp_a.xy)[ga].astype(np.float64)
    b = host(kp_b.xy)[host(idx_b)[ga]].astype(np.float64)
    az = a[:, 0] + 1j * a[:, 1]
    bz = b[:, 0] + 1j * b[:, 1]
    rng = np.random.default_rng(seed)
    best = np.zeros(n, bool)
    for _ in range(iters):
        i, j = rng.choice(n, 2, replace=False)
        if abs(az[i] - az[j]) < 1e-9:
            continue
        alpha = (bz[i] - bz[j]) / (az[i] - az[j])
        beta = bz[i] - alpha * az[i]
        inl = np.abs(alpha * az + beta - bz) < tol
        if inl.sum() > best.sum():
            best = inl
    mask = np.zeros_like(good_np)
    mask[ga[best]] = True
    return mask
