"""Two-view geometry estimators.

Port of ``surikatoko_tpu/models/sfm/mvg.py`` (reference py_proto/suriko/
mvg.py: homography DLT :89-175, fundamental 8-point :2396-2518, essential
matrix + ExtractRotTransFromEssentialMat :721, Sampson correction :2558).
The estimators that RANSAC fits take a leading batch of problems ([..., N,
2] points, [..., N] masks) so a whole set of hypotheses is one call; the
Gauss-Newton polishes are fixed-length loops with ``torch.func.jacfwd``
Jacobians. Conventions: x2^T F x1 = 0 and x2^T E x1 = 0 with x = [u, v, 1];
poses map frame1 -> frame2 (x2 ~ R x1 + t).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from surikatoko_tpu_torch.geom import so3
from surikatoko_tpu_torch.geom.se3 import SE3


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _eye(n, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _normalize_points(x: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization: zero-mean, mean distance sqrt(2). Returns
    (x_norm [..., N, 2], T [..., 3, 3]) with x_norm_h = T @ x_h."""
    m = mask.to(x.dtype)
    n = torch.clamp(m.sum(-1), min=1.0)
    mean = (x * m[..., None]).sum(-2) / n[..., None]
    d = torch.sqrt(((x - mean[..., None, :]) ** 2).sum(-1) + 1e-30)
    mean_d = (d * m).sum(-1) / n
    s = (2.0 ** 0.5) / torch.clamp(mean_d, min=1e-12)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([s, z, -s * mean[..., 0], z, s, -s * mean[..., 1],
                     z, z, o], dim=-1).reshape(s.shape + (3, 3))
    return (x - mean[..., None, :]) * s[..., None, None], T


def _smallest_right_singular(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svd(A, full_matrices=True)[2][..., -1, :]


def _epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """[..., N, 9] rows of x2^T F x1 = 0 in F's row-major entries."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    return torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v,
                        torch.ones_like(u)], dim=-1)


def _fro_normalize(F: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(F * F, dim=(-2, -1)))
    return F / torch.clamp(n, min=1e-30)[..., None, None]


# ---------------------------------------------------------------- homography
def homography_dlt(x1: torch.Tensor, x2: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """H [..., 3, 3] with x2_h ~ H x1_h from >= 4 correspondences (DLT,
    normalized). Masked rows contribute zero equations."""
    x1n, T1 = _normalize_points(x1, mask)
    x2n, T2 = _normalize_points(x2, mask)
    u, v = x1n[..., 0], x1n[..., 1]
    up, vp = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u)
    o = torch.ones_like(u)
    r1 = torch.stack([-u, -v, -o, z, z, z, up * u, up * v, up], dim=-1)
    r2 = torch.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], dim=-1)
    mm = torch.cat([mask, mask], dim=-1).to(x1.dtype)
    A = torch.cat([r1, r2], dim=-2) * mm[..., None]
    Hn = _smallest_right_singular(A).reshape(A.shape[:-2] + (3, 3))
    H = torch.linalg.inv(T2) @ Hn @ T1
    return H / H[..., 2:3, 2:3]


def decompose_homography_calibrated(H: torch.Tensor):
    """Decompose a calibrated homography (H = R + t n^T / d, unit-normalized)
    into the (R, t_over_d, n) candidates [4, ...] (Malis & Vargas closed form
    via the SVD of H^T H, each polished by Gauss-Newton on ||H - R - t n^T||).
    The caller disambiguates by cheirality."""
    s = torch.linalg.svd(H)[1]
    Hn = H / s[1]
    I3 = _eye(3, H)
    S = Hn.T @ Hn - I3

    def minor(i, j):
        rows = [k for k in range(3) if k != i]
        cols = [k for k in range(3) if k != j]
        sub = S[rows][:, cols]
        return sub[0, 0] * sub[1, 1] - sub[0, 1] * sub[1, 0]

    M00, M11, M22 = minor(0, 0), minor(1, 1), minor(2, 2)
    M01, M02, M12 = minor(0, 1), minor(0, 2), minor(1, 2)
    eps = 1e-12

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    i = torch.argmax(torch.abs(torch.diagonal(S)))
    sq = [safe_sqrt(-M00), safe_sqrt(-M11), safe_sqrt(-M22)]

    def sgn(x):
        return torch.where(x >= 0, 1.0, -1.0).to(H.dtype)

    branches = (
        (torch.stack([S[0, 0], S[0, 1] + sq[2], S[0, 2] + sgn(M12) * sq[1]]),
         torch.stack([S[0, 0], S[0, 1] - sq[2], S[0, 2] - sgn(M12) * sq[1]])),
        (torch.stack([S[0, 1] + sq[2], S[1, 1], S[1, 2] - sgn(M02) * sq[0]]),
         torch.stack([S[0, 1] - sq[2], S[1, 1], S[1, 2] + sgn(M02) * sq[0]])),
        (torch.stack([S[0, 2] + sgn(M01) * sq[1], S[1, 2] + sq[0], S[2, 2]]),
         torch.stack([S[0, 2] - sgn(M01) * sq[1], S[1, 2] - sq[0], S[2, 2]])))
    na = torch.stack([b[0] for b in branches])[i]
    nb = torch.stack([b[1] for b in branches])[i]
    na = na / torch.clamp(torch.linalg.norm(na), min=eps)
    nb = nb / torch.clamp(torch.linalg.norm(nb), min=eps)

    def rt_from_normal(n):
        # with H = R + t n^T (unit second singular value): t/d = (H - R) n.
        # Seed t_d = (H - I) n, project (H - t_d n^T) onto SO(3), then
        # re-estimate t_d against the projected R (fixed-point sweeps)
        t_d = (Hn - I3) @ n
        for _ in range(3):
            R = so3.project_onto_so3(Hn - torch.outer(t_d, n))
            t_d = (Hn - R) @ n
        # polish (R, t, n) jointly by Gauss-Newton on ||H - R - t n^T||_F
        z = torch.zeros(3, dtype=H.dtype, device=H.device)
        for _ in range(6):
            def res(w, dt, dn, R_c=R, t_c=t_d, n_c=n):
                return (Hn - so3.exp(w) @ R_c
                        - torch.outer(t_c + dt, n_c + dn)).reshape(-1)
            r = res(z, z, z)
            J = torch.cat(jacfwd(res, argnums=(0, 1, 2))(z, z, z), dim=1)
            Hm = J.T @ J + 1e-10 * _eye(9, H)
            d = torch.linalg.solve(Hm, -(J.T @ r))
            R, t_d, n = so3.exp(d[:3]) @ R, t_d + d[3:6], n + d[6:9]
        # re-normalize the plane normal, folding scale into t
        scale = torch.clamp(torch.linalg.norm(n), min=eps)
        return R, t_d * scale, n / scale

    cands = [rt_from_normal(n) for n in (na, nb, -na, -nb)]
    return tuple(torch.stack([c[k] for c in cands]) for k in range(3))


# ------------------------------------------------------ fundamental/essential
def fundamental_8point(x1: torch.Tensor, x2: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point fundamental matrix [..., 3, 3] (rank 2 enforced)."""
    x1n, T1 = _normalize_points(x1, mask)
    x2n, T2 = _normalize_points(x2, mask)
    A = _epipolar_rows(x1n, x2n) * mask.to(x1.dtype)[..., None]
    F = _smallest_right_singular(A).reshape(A.shape[:-2] + (3, 3))
    U, s, Vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    F = (U * s[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ F @ T1
    return _fro_normalize(F)


def host_eig(fn, a: torch.Tensor):
    """``fn`` (``torch.linalg.eig`` or ``eigvals``) of a batch of small
    nonsymmetric matrices, computed on the host and returned to ``a``'s
    device: one copy each way for the batch. (Torch hands a CUDA batch to
    MAGMA's geev one matrix at a time, on the host as well: ~10x slower for
    512 10x10 matrices.)"""
    out = fn(a.cpu())
    if isinstance(out, torch.Tensor):
        return out.to(a.device)
    return tuple(x.to(a.device) for x in out)


def _cubic_roots(c: torch.Tensor) -> torch.Tensor:
    """[..., 3] complex roots of c3 a^3 + c2 a^2 + c1 a + c0 (c = [..., 4],
    leading coefficient first): the eigenvalues of the companion matrix, as
    ``jnp.roots``; their order is the eigensolver's."""
    top = -c[..., 1:] / c[..., :1]                                  # [..., 3]
    z, o = torch.zeros_like(top[..., 0]), torch.ones_like(top[..., 0])
    comp = torch.stack([top[..., 0], top[..., 1], top[..., 2],
                        o, z, z, z, o, z], dim=-1).reshape(c.shape[:-1] + (3, 3))
    return host_eig(torch.linalg.eigvals, comp)


def fundamental_7point(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """7-point algorithm: [..., 3, 3, 3] candidate fundamental matrices (up
    to 3 real roots of det(a F1 + (1-a) F2) = 0; a complex root's slot
    repeats the largest real root, so scoring can treat all 3 alike)."""
    A = _epipolar_rows(x1, x2)                                   # [..., 7, 9]
    Vt = torch.linalg.svd(A, full_matrices=True)[2]
    F1 = Vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    F2 = Vt[..., -2, :].reshape(A.shape[:-2] + (3, 3))

    # det(a F1 + (1-a) F2) = c3 a^3 + c2 a^2 + c1 a + c0 by interpolation
    # at a = 0, 1, -1, 2 (the JAX package's c3 adds (d(-1) - d(1)) / 6, so
    # its roots are not those of the determinant: ROADMAP C.3)
    def d(a):
        return torch.linalg.det(a * F1 + (1 - a) * F2)

    d0, d1, dm1, d2 = d(0.0), d(1.0), d(-1.0), d(2.0)
    c0 = d0
    c2 = (d1 + dm1) / 2.0 - c0
    c3 = (d2 - d1 + dm1 - d0 - 4 * c2) / 6.0
    c1 = d1 - c0 - c2 - c3
    roots = _cubic_roots(torch.stack([c3, c2, c1, c0], dim=-1))
    real = torch.where(torch.abs(roots.imag) < 1e-6, roots.real,
                       torch.nan).to(x1.dtype)
    first_real = torch.where(torch.isnan(real), -torch.inf, real).amax(-1)
    alphas = torch.where(torch.isnan(real), first_real[..., None], real)
    a = alphas[..., None, None]
    return _fro_normalize(a * F1[..., None, :, :]
                          + (1 - a) * F2[..., None, :, :])


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor,
                               K2: torch.Tensor) -> torch.Tensor:
    return project_to_essential(K2.transpose(-1, -2) @ F @ K1)


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * d) @ Vt


def essential_8point(x1n: torch.Tensor, x2n: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Essential matrix from normalized (calibrated) image coords."""
    return project_to_essential(fundamental_8point(x1n, x2n, mask))


def sampson_distance_sq(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
                        ) -> torch.Tensor:
    """First-order geometric (Sampson) squared distance per correspondence:
    F [..., 3, 3] with x [N, 2] (or [..., N, 2]) gives [..., N]."""
    x1h = _homog(x1)
    x2h = _homog(x2)
    Fx1 = x1h @ F.transpose(-1, -2)          # [..., N, 3]
    Ftx2 = x2h @ F                           # [..., N, 3]
    e = torch.sum(x2h * Fx1, dim=-1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return e * e / torch.clamp(denom, min=1e-30)


def refine_essential_sampson(E: torch.Tensor, x1n: torch.Tensor,
                             x2n: torch.Tensor, mask: torch.Tensor,
                             iters: int = 8) -> torch.Tensor:
    """Gauss-Newton on the 5-dof essential manifold (E = [t]_x R, |t| = 1)
    minimizing the Sampson error, as a polish."""
    R, t = decompose_essential_best(E, x1n, x2n, mask)
    m = mask.to(x1n.dtype)
    z = torch.zeros(3, dtype=x1n.dtype, device=x1n.device)
    for _ in range(iters):
        def res(w, dt, R=R, t=t):
            Rn = so3.exp(w) @ R
            tn = t + dt
            tn = tn / torch.clamp(torch.linalg.norm(tn), min=1e-12)
            En = so3.skew(tn) @ Rn
            return torch.sqrt(sampson_distance_sq(En, x1n, x2n) + 1e-30) * m
        r = res(z, z)
        J = torch.cat(jacfwd(res, argnums=(0, 1))(z, z), dim=1)
        Hm = J.T @ J + 1e-9 * _eye(6, x1n)
        d = torch.linalg.solve(Hm, -(J.T @ r))
        t_new = t + d[3:]
        t = t_new / torch.clamp(torch.linalg.norm(t_new), min=1e-12)
        R = so3.exp(d[:3]) @ R
    return project_to_essential(so3.skew(t) @ R)


def decompose_essential(E: torch.Tensor):
    """The four (R, t) candidates [..., 4, ...] with x2 ~ R x1 + t (HZ
    9.6.2)."""
    U, _, Vt = torch.linalg.svd(E)
    # make the rotations proper
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _triangulate_midpoint_depths(R, t, x1n, x2n):
    """Depths (z1, z2) of midpoint triangulation for cheirality testing:
    R [..., 3, 3], t [..., 3] with points [N, 2] give [..., N] each."""
    f1 = _homog(x1n)
    f2 = _homog(x2n)
    Rf1 = f1 @ R.transpose(-1, -2)                       # [..., N, 3]
    a = torch.sum(Rf1 * Rf1, dim=-1)
    b = -torch.sum(Rf1 * f2, dim=-1)
    c = torch.sum(f2 * f2, dim=-1)
    d = torch.sum(Rf1 * t[..., None, :], dim=-1)
    e = -torch.sum(f2 * t[..., None, :], dim=-1)
    den = a * c - b * b
    den = torch.where(torch.abs(den) < 1e-20, 1e-20, den)
    return (b * e - c * d) / den, (b * d - a * e) / den


def decompose_essential_best(E: torch.Tensor, x1n: torch.Tensor,
                             x2n: torch.Tensor, mask: torch.Tensor):
    """(R, t) candidate with the most points in front of both cameras
    (reference ExtractRotTransFromEssentialMat); ties go to the first."""
    Rs, ts = decompose_essential(E)
    z1, z2 = _triangulate_midpoint_depths(Rs, ts, x1n, x2n)      # [4, N]
    counts = ((z1 > 0) & (z2 > 0) & mask).sum(-1)
    i = torch.argmax(counts)
    return Rs[i], ts[i]


def relative_pose_from_correspondences(x1n: torch.Tensor, x2n: torch.Tensor,
                                       mask: torch.Tensor,
                                       refine: bool = True) -> SE3:
    """Two-view relative pose (calibrated): 8-point essential, cheirality-
    selected decomposition, optional Sampson GN polish. Returns
    frame2-from-frame1 with |t| = 1."""
    E = essential_8point(x1n, x2n, mask)
    if refine:
        E = refine_essential_sampson(E, x1n, x2n, mask)
    R, t = decompose_essential_best(E, x1n, x2n, mask)
    return SE3(R, t)
