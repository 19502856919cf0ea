"""Relative-motion and depth estimation for incremental SfM.

Port of ``surikatoko_tpu/models/mvf/relative_motion.py`` (reference
multi-view-factorization.cpp):
  find_relative_motion_multi_points <- FindRelativeMotionMultiPoints :107
    (3N x 12 system A [c1 (x) skew(c2) | skew(c2)/depth] via Kronecker
     product, smallest right singular vector, then ProjectOntoSO3 :78 =
     MASKS formulas 8.41-8.43 with the cube-root(det) scale on T)
  estimate_point_depth <- Estimate3DPointDepthFromFrames :223 (MASKS 8.44)

Inputs are *normalized homogeneous* image coordinates [x, y, 1] (calibrated
camera, "meters"). Rows of invalid correspondences are zeroed by masks.

Where the JAX package vmaps a function over tracks, the functions here take
leading batch dimensions; its ``lax.scan`` Gauss-Newton loops are Python
loops of fixed length, and its ``jax.jacfwd`` Jacobians are the closed-form
projection Jacobians (2x6 for the pose, 2x3 for a point), which the tests
hold to ``torch.func.jacfwd``. Nothing here reads a value back to the host.
"""

from __future__ import annotations

import torch

from surikatoko_tpu_torch.geom import so3
from surikatoko_tpu_torch.geom.se3 import SE3


def find_relative_motion_multi_points(
    c1: torch.Tensor,             # [N,3] normalized coords in anchor frame
    c2: torch.Tensor,             # [N,3] normalized coords in target frame
    depths_anchor: torch.Tensor,  # [N] depth of each point in the anchor frame
    mask: torch.Tensor,           # [N] valid correspondences
) -> tuple[SE3, torch.Tensor]:
    """(target_from_anchor SE3, ok). Builds the masked 3N x 12 system
      [c1_k * skew(c2) | skew(c2)/depth] [vec(R); T] = 0,
    takes the smallest right singular vector, and projects the 3x3 block onto
    SO(3) with the matched scale for T.

    The null vector's sign is the SVD's choice, and it may differ between
    LAPACK, cuSOLVER and XLA. The result does not depend on it: negating
    [vec(R); T] negates det(U V^T) of the 3x3 block, so ``sign`` flips, and
    R = sign U V^T and T = sign T_noisy / det_S^(1/3) come out the same."""
    dtype = c1.dtype
    N = c1.shape[0]
    c2_skew = so3.skew(c2)                                     # [N,3,3]
    m = mask.to(dtype)[:, None, None]
    # Kronecker: columns 3*k..3*k+2 = c1[k] * skew(c2)
    A_R = torch.einsum("nk,nab->nakb", c1, c2_skew).reshape(N, 3, 9)
    A_T = (1.0 / depths_anchor)[:, None, None] * c2_skew
    A = torch.cat([A_R * m, A_T * m], dim=-1).reshape(-1, 12)

    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    r_and_t = Vh[-1]
    # r_and_t[0:9] holds R stacked column-major (the reference's Eigen Map):
    # columns are r[0:3], r[3:6], r[6:9]
    R_noisy = torch.stack([r_and_t[0:3], r_and_t[3:6], r_and_t[6:9]], dim=1)
    T_noisy = r_and_t[9:12]

    # ProjectOntoSO3 (MASKS 8.41-8.43)
    U, S, Vt2 = torch.linalg.svd(R_noisy)
    det_S = torch.prod(S)
    no_guts = U @ Vt2
    sign = torch.where(torch.linalg.det(no_guts) < 0, -1.0, 1.0).to(dtype)
    R_valid = sign * no_guts
    # singular values are >= 0, so their product's cube root is a power
    s_scale = sign / det_S ** (1.0 / 3.0)
    T_valid = s_scale * T_noisy
    ok = ((torch.abs(det_S) > 1e-20) & torch.isfinite(R_valid).all()
          & torch.isfinite(T_valid).all())
    return SE3(R_valid, T_valid), ok


def _proj_jacobian(xc: torch.Tensor, z: torch.Tensor,
                   z_free: torch.Tensor | None = None) -> torch.Tensor:
    """[..., 2, 3] Jacobian of (x/z, y/z) at camera point ``xc`` [..., 3],
    divided by ``z`` [..., 1]. ``z_free`` (bool [..., 1]) zeroes the z
    column where the depth was clamped to a constant."""
    inv_z = 1.0 / z[..., 0]
    dz_x = -xc[..., 0] * inv_z * inv_z
    dz_y = -xc[..., 1] * inv_z * inv_z
    if z_free is not None:
        dz_x = torch.where(z_free[..., 0], dz_x, 0.0)
        dz_y = torch.where(z_free[..., 0], dz_y, 0.0)
    zero = torch.zeros_like(inv_z)
    return torch.stack([torch.stack([inv_z, zero, dz_x], dim=-1),
                        torch.stack([zero, inv_z, dz_y], dim=-1)], dim=-2)


def _solve_small(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """H^-1 rhs for a batch of small systems, with no error check (a
    singular H gives non-finite entries, as ``jnp.linalg.solve`` does, and
    no host read)."""
    return torch.linalg.solve_ex(H, rhs[..., None])[0][..., 0]


def pose_residuals_and_jacobian(points_w, obs_norm, m, R, t):
    """(r [..., N, 2], J [..., N, 2, 6]) of the masked reprojection residual
    at cfw (R, t), J over the left-multiplied rotation increment w and the
    translation increment dt: x_c = exp(w) R X + t + dt, so
    d x_c / dw = -[R X]_x and d x_c / d dt = I."""
    y = points_w @ R.transpose(-1, -2)                          # R X
    xc = y + t[..., None, :]
    z = xc[..., 2:3]
    mm = m[..., None]
    r = (xc[..., :2] / z - obs_norm[..., :2]) * mm
    dp = _proj_jacobian(xc, z) * mm[..., None]                  # [..., N,2,3]
    J = torch.cat([-dp @ so3.skew(y), dp], dim=-1)
    return r, J


def refine_pose_pnp(
    points_w: torch.Tensor,   # [..., N, 3] known 3D points (world frame)
    obs_norm: torch.Tensor,   # [..., N, 3] normalized homogeneous observations
    mask: torch.Tensor,       # [..., N]
    R0: torch.Tensor, t0: torch.Tensor,   # [..., 3, 3], [..., 3] cfw guess
    iters: int = 10,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gauss-Newton 3D-2D pose refinement (6-dof cfw), returns (R, t, rms).

    This is an improvement over the reference, whose SVD-12 localizer is
    noise-fragile by its own admission ("this algo ... is unreliable",
    multi-view-factorization.cpp:121): the linear estimate seeds a few GN
    iterations on the reprojection residual, restoring noise robustness.
    Leading batch dimensions refine several poses at once.
    """
    dtype = points_w.dtype
    m = mask.to(dtype)
    eye6 = 1e-12 * torch.eye(6, dtype=dtype, device=points_w.device)
    R, t = R0, t0
    for _ in range(iters):
        r, J = pose_residuals_and_jacobian(points_w, obs_norm, m, R, t)
        H = torch.einsum("...nia,...nib->...ab", J, J) + eye6
        g = torch.einsum("...nia,...ni->...a", J, r)
        d = _solve_small(H, -g)
        R = so3.exp(d[..., :3]) @ R
        t = t + d[..., 3:]
    r, _ = pose_residuals_and_jacobian(points_w, obs_norm, m, R, t)
    n = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    rms = torch.sqrt(torch.sum(r * r, dim=(-1, -2)) / n)
    return R, t, rms


def point_residuals_and_jacobian(X, obs_norm, m, R, t):
    """(r [..., M, 2], J [..., M, 2, 3]) of one point's masked residuals
    against its observations, the depth clamped away from 0 (a clamped
    depth is a constant: its column of J is 0)."""
    xc = torch.einsum("...mij,...j->...mi", R, X) + t
    z = xc[..., 2:3]
    z_free = torch.abs(z) >= 1e-9
    zs = torch.where(z_free, z, 1e-9)
    mm = m[..., None]
    r = (xc[..., :2] / zs - obs_norm[..., :2]) * mm
    J = _proj_jacobian(xc, zs, z_free) @ R * mm[..., None]
    return r, J


def refine_point_gn(
    x0: torch.Tensor,         # [..., 3] initial world point
    obs_norm: torch.Tensor,   # [..., M, 3] normalized homogeneous observations
    R: torch.Tensor,          # [..., M, 3, 3] cfw rotations of the observing frames
    t: torch.Tensor,          # [..., M, 3]
    mask: torch.Tensor,       # [..., M]
    iters: int = 5,
) -> torch.Tensor:
    """Gauss-Newton polish of a point against all its observations.

    The linear MASKS-8.44 depth (estimate_point_depth, the reference's
    Estimate3DPointDepthFromFrames, multi-view-factorization.cpp:223) is an
    errors-in-variables estimator: measurement noise enters the denominator
    squared, so depths are systematically over-estimated and an incremental
    run inflates in scale frame over frame. A few GN iterations on the true
    reprojection residual remove the bias. Masked rows contribute zero; a
    step that is not finite is not taken. Leading batch dimensions polish
    one point each."""
    dtype = x0.dtype
    m = mask.to(dtype)
    eye3 = 1e-12 * torch.eye(3, dtype=dtype, device=x0.device)
    X = x0
    for _ in range(iters):
        r, J = point_residuals_and_jacobian(X, obs_norm, m, R, t)
        H = torch.einsum("...mia,...mib->...ab", J, J) + eye3
        g = torch.einsum("...mia,...mi->...a", J, r)
        d = _solve_small(H, -g)
        d = torch.where(torch.isfinite(d).all(dim=-1, keepdim=True), d, 0.0)
        X = X + d
    return X


def estimate_point_depth(
    x_base: torch.Tensor,     # [..., 3] normalized coords in the track's base frame
    xs: torch.Tensor,         # [..., F, 3] normalized coords in other frames
    R_fb: torch.Tensor,       # [..., F, 3, 3] frame-from-base rotations
    T_fb: torch.Tensor,       # [..., F, 3]
    mask: torch.Tensor,       # [..., F] frames where the track is observed (excl. base)
) -> torch.Tensor:
    """Depth of the point in its base frame (MASKS 8.44):
      alpha = -sum <skew(xi) Ti, skew(xi) Ri x1> / sum |skew(xi) Ti|^2
      depth = 1/alpha."""
    xi_skew = so3.skew(xs)
    h1 = torch.einsum("...fab,...fb->...fa", xi_skew, T_fb)
    Rx = torch.einsum("...fbc,...c->...fb", R_fb, x_base)
    h2 = torch.einsum("...fab,...fb->...fa", xi_skew, Rx)
    m = mask.to(x_base.dtype)
    num = torch.sum(torch.sum(h1 * h2, dim=-1) * m, dim=-1)
    den = torch.sum(torch.sum(h1 * h1, dim=-1) * m, dim=-1)
    alpha = -num / torch.where(den == 0, 1.0, den)
    return 1.0 / torch.where(alpha == 0, torch.inf, alpha)
