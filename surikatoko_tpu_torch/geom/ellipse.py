"""Uncertainty ellipses and ellipsoids from covariance matrices.

Port of ``surikatoko_tpu/geom/ellipse.py`` (reference obs-geom.cpp:751-1030):
eigendecompose a 2x2 (or 3x3) positive-definite covariance, scale the
semi-axes by the chi-square quantile of the requested confidence, and report
the rotated ellipse with its axis-aligned bounds (the NCC search's gate).

The quantiles are closed form: dof = 2 is exact, dof = 3 is the
Wilson-Hilferty cube approximation. ``torch.linalg.eigh`` may pick the
opposite sign of an eigenvector from LAPACK's in another library, so compare
R through R diag(a^2) R^T and the bounds; det R = +1 either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RotatedEllipse2D(NamedTuple):
    center: torch.Tensor     # [..., 2]
    R: torch.Tensor          # [..., 2, 2] world_from_ellipse rotation
    semi_axes: torch.Tensor  # [..., 2]


class RotatedEllipsoid3D(NamedTuple):
    center: torch.Tensor     # [..., 3]
    R: torch.Tensor          # [..., 3, 3]
    semi_axes: torch.Tensor  # [..., 3]


def _f64(p) -> torch.Tensor:
    return p if isinstance(p, torch.Tensor) else torch.as_tensor(
        p, dtype=torch.float64)


def chi_square_quantile_2dof(confidence) -> torch.Tensor:
    """Exact: F(x) = 1 - exp(-x/2), so x = -2 ln(1 - p)."""
    return -2.0 * torch.log1p(-_f64(confidence))


def chi_square_quantile_3dof(confidence) -> torch.Tensor:
    """Wilson-Hilferty approximation for dof = 3."""
    z = _norm_ppf(_f64(confidence))
    k = 3.0
    return k * (1.0 - 2.0 / (9.0 * k) + z * (2.0 / (9.0 * k)) ** 0.5) ** 3


_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
      1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
      6.680131188771972e+01, -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
      -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
      3.754408661907416e+00)


def _norm_ppf(p: torch.Tensor) -> torch.Tensor:
    """Peter Acklam's rational approximation of the inverse normal CDF."""
    a, b, c, d = _A, _B, _C, _D
    plow, phigh = 0.02425, 1 - 0.02425

    def central(p):
        q = p - 0.5
        r = q * q
        num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
        den = (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
        return q * num / den

    def upper(p):
        q = torch.sqrt(-2 * torch.log(torch.clamp(1 - p, min=1e-300)))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        den = ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        return num / den

    lower = -upper(1 - torch.clamp(p, 1e-12, 1.0))
    return torch.where(p < plow, lower,
                       torch.where(p > phigh, upper(p),
                                   central(torch.clamp(p, plow, phigh))))


def _eigh_scaled(cov: torch.Tensor, chi2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    vals, vecs = torch.linalg.eigh(cov)
    vals = torch.clamp(vals, min=0.0)
    # largest axis first, as the reference
    semi = torch.sqrt(vals * chi2).flip(-1)
    vecs = vecs.flip(-1)
    # det +1, so R is a rotation
    sign = torch.where(torch.linalg.det(vecs) < 0, -1.0, 1.0).to(vecs.dtype)
    vecs = torch.cat([vecs[..., :, :-1], vecs[..., :, -1:] * sign[..., None, None]],
                     dim=-1)
    return semi, vecs, vals


def ellipse_from_covariance(cov: torch.Tensor, center: torch.Tensor,
                            confidence: float = 0.95) -> RotatedEllipse2D:
    chi2 = chi_square_quantile_2dof(confidence).to(cov.dtype)
    semi, vecs, _ = _eigh_scaled(cov, chi2)
    return RotatedEllipse2D(center=center, R=vecs, semi_axes=semi)


def ellipsoid_from_covariance(cov: torch.Tensor, center: torch.Tensor,
                              confidence: float = 0.95) -> RotatedEllipsoid3D:
    chi2 = chi_square_quantile_3dof(confidence).to(cov.dtype)
    semi, vecs, _ = _eigh_scaled(cov, chi2)
    return RotatedEllipsoid3D(center=center, R=vecs, semi_axes=semi)


def is_ellipsoid_extractable(cov: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """True when the covariance admits a real uncertainty ellipsoid (every
    eigenvalue finite and > eps); reference ``CheckSalientPoint``
    (davison-mono-slam.cpp:4152) removes landmarks failing this."""
    vals = torch.linalg.eigvalsh(cov)
    return torch.isfinite(vals).all(dim=-1) & (vals > eps).all(dim=-1)


def ellipse_bounds(e: RotatedEllipse2D) -> torch.Tensor:
    """Axis-aligned bounding rect [x, y, w, h] of a rotated ellipse
    (reference ``GetEllipseBounds2``, obs-geom.cpp:751)."""
    # extent along world axis i: sqrt(sum_j (R[i,j] a_j)^2)
    ext = torch.sqrt(torch.sum((e.R * e.semi_axes[..., None, :]) ** 2, dim=-1))
    return torch.cat([e.center - ext, 2.0 * ext], dim=-1)
