"""Binary patch descriptors and Hamming matching for wide-baseline pipelines.

Port of ``surikatoko_tpu/vision/descriptors.py``: BRIEF-style 256-bit
descriptors (a fixed Gaussian sampling pattern over a 5x5 box-blurred patch)
for all keypoints in one batched gather, and an all-pairs Hamming matcher
with mutual-nearest and ratio tests.

- :func:`compute_brief`: upright BRIEF.
- :func:`compute_oriented_brief`: ORB-style steered BRIEF, the pattern
  rotated per keypoint by its intensity-centroid orientation.

A descriptor is [N_WORDS] **int32** words holding the bit patterns of the
JAX package's uint32 words (bit i of word w is comparison 32 w + i): torch's
uint32 has no shifts or adds on the CPU, so the words are packed in int64
and stored as int32, and the popcount runs on int64. The blur is shifted
adds (separable: weighted horizontal taps, then vertical sums), not a
convolution: a convolution library picks its algorithm per device and
shape, and a Winograd or FFT one would flip near-tie bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

N_BITS = 256
N_WORDS = N_BITS // 32
_PATCH = 24  # half-size of the descriptor support


def _sampling_pattern(seed: int = 7) -> np.ndarray:
    """[N_BITS, 4] integer offsets (x1, y1, x2, y2), Gaussian, clipped."""
    rng = np.random.default_rng(seed)
    pts = np.clip(np.round(rng.normal(scale=_PATCH / 4.5, size=(N_BITS, 4))),
                  -(_PATCH - 1), _PATCH - 1).astype(np.int32)
    return pts

_PATTERN = _sampling_pattern()

_ORIENT_R = 15  # intensity-centroid radius (ORB uses 15)


def _centroid_grid() -> np.ndarray:
    """[(2R+1)^2, 3] columns (dx, dy, in_circle) for the orientation moment."""
    r = _ORIENT_R
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (dx * dx + dy * dy) <= r * r
    return np.stack([dx.ravel(), dy.ravel(), mask.ravel()], axis=1).astype(np.int32)

_CENTROID = _centroid_grid()

# margin of the steered pattern: the worst-case rotated offset
# (|p| <= sqrt(2) * (PATCH - 1))
_STEER_MARGIN = int(np.ceil(np.sqrt(2.0) * (_PATCH - 1))) + 1


@functools.cache
def _consts(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The sampling pattern (int64 and float32) and the centroid grid on
    ``device``, made there once."""
    return (torch.as_tensor(_PATTERN, dtype=torch.int64, device=device),
            torch.as_tensor(_PATTERN, dtype=torch.float32, device=device),
            torch.as_tensor(_CENTROID, dtype=torch.int64, device=device))


def _box_blur(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k x k mean filter with zero 'SAME' padding: k horizontal taps
    weighted by the float32 1/k^2, then k vertical taps summed."""
    H, W = img.shape
    r = k // 2
    w = float(np.float32(1.0 / (k * k)))
    p = F.pad(img, (r, r, r, r))
    rows = functools.reduce(torch.add, (p[:, j:j + W] * w for j in range(k)))
    return functools.reduce(torch.add, (rows[i:i + H] for i in range(k)))


def _round_clip(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """round half to even (``jnp.round``), then clip, as int64 indices."""
    return torch.clamp(torch.round(v).to(torch.int64), lo, hi)


def _pack(bits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[K, N_BITS] bool -> [K, N_WORDS] int32 words (bit i of word w is
    bits[32 w + i]), zeroed where not ``valid``."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(-1, N_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    words = words * valid[:, None].to(torch.int64)
    # the uint32 bit pattern as int32: subtract 2^32 above 2^31 - 1
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def compute_brief(image: torch.Tensor, keypoints: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """[K, N_WORDS] int32 descriptors at keypoints [K,2] (x, y)."""
    img = _box_blur(image.to(torch.float32))
    H, W = img.shape
    pat = _consts(img.device)[0]
    kx = _round_clip(keypoints[:, 0], _PATCH, W - _PATCH - 1)
    ky = _round_clip(keypoints[:, 1], _PATCH, H - _PATCH - 1)
    x1 = kx[:, None] + pat[None, :, 0]
    y1 = ky[:, None] + pat[None, :, 1]
    x2 = kx[:, None] + pat[None, :, 2]
    y2 = ky[:, None] + pat[None, :, 3]
    return _pack(img[y1, x1] < img[y2, x2], valid)


def keypoint_orientations(image: torch.Tensor, keypoints: torch.Tensor
                          ) -> torch.Tensor:
    """[K] patch orientation (radians) by intensity centroid: theta =
    atan2(m01, m10) with mpq = sum x^p y^q I(x, y) over a radius-15 disc."""
    img = image.to(torch.float32)
    H, W = img.shape
    r = _ORIENT_R
    kx = _round_clip(keypoints[:, 0], r, W - r - 1)
    ky = _round_clip(keypoints[:, 1], r, H - r - 1)
    g = _consts(img.device)[2]
    gf = g.to(torch.float32)
    I = img[ky[:, None] + g[None, :, 1], kx[:, None] + g[None, :, 0]]
    I = I * gf[None, :, 2]                                       # [K, P]
    m10 = torch.sum(I * gf[None, :, 0], dim=1)
    m01 = torch.sum(I * gf[None, :, 1], dim=1)
    return torch.atan2(m01, m10)


def compute_oriented_brief(image: torch.Tensor, keypoints: torch.Tensor,
                           valid: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Steered BRIEF: ([K, N_WORDS] int32 descriptors, [K] angles).

    The fixed sampling pattern is rotated per keypoint by the intensity-
    centroid orientation, so descriptors of the same patch seen under
    in-plane rotation agree (ORB's steering, without its learned pattern)."""
    img = _box_blur(image.to(torch.float32))
    H, W = img.shape
    pat = _consts(img.device)[1]

    theta = keypoint_orientations(img, keypoints)             # [K]
    c, s = torch.cos(theta), torch.sin(theta)

    m = _STEER_MARGIN
    kx = _round_clip(keypoints[:, 0], m, W - m - 1)
    ky = _round_clip(keypoints[:, 1], m, H - m - 1)

    def rot(px, py):
        rx = c[:, None] * px[None, :] - s[:, None] * py[None, :]
        ry = s[:, None] * px[None, :] + c[:, None] * py[None, :]
        return (torch.round(rx).to(torch.int64),
                torch.round(ry).to(torch.int64))

    dx1, dy1 = rot(pat[:, 0], pat[:, 1])
    dx2, dy2 = rot(pat[:, 2], pat[:, 3])
    bits = (img[ky[:, None] + dy1, kx[:, None] + dx1]
            < img[ky[:, None] + dy2, kx[:, None] + dx2])
    return _pack(bits, valid), theta


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor (SWAR on int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[Ka, Kb] int32 pairwise Hamming distances of packed descriptors."""
    x = torch.bitwise_xor(da[:, None, :], db[None, :, :])
    return popcount32(x).sum(dim=-1).to(torch.int32)


class MatchResult(NamedTuple):
    idx_b: torch.Tensor     # [Ka] best match in B for each A keypoint
    distance: torch.Tensor  # [Ka]
    good: torch.Tensor      # [Ka] mutual-NN + ratio + threshold gate


def match_descriptors(da: torch.Tensor, db: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      max_distance: int = 64,
                      ratio: float = 0.85) -> MatchResult:
    """Mutual nearest-neighbor Hamming matching with Lowe's ratio test (in
    float32, as the JAX package compares). Ties go to the first index."""
    D = hamming_matrix(da, db)
    big = 10_000
    D = torch.where(valid_a[:, None] & valid_b[None, :], D, big)

    best_b = torch.argmin(D, dim=1)
    d1 = D.gather(1, best_b[:, None])[:, 0]
    # second best for the ratio test
    rows = torch.arange(D.shape[0], device=D.device)
    d2 = D.index_put((rows, best_b), torch.tensor(big, dtype=D.dtype,
                                                   device=D.device)).min(dim=1).values
    # mutual check
    best_a_of_b = torch.argmin(D, dim=0)
    mutual = best_a_of_b[best_b] == rows

    good = ((d1 <= max_distance) & mutual
            & (d1.to(torch.float32) <= ratio * d2.to(torch.float32)))
    return MatchResult(idx_b=best_b, distance=d1, good=good & valid_a)
