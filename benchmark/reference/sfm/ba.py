"""Bundle adjustment by Levenberg-Marquardt with Kanatani's damping
schedule and the textbook Schur complement.

The unknowns are the points and, for each camera, its centre c and its
orientation R_wc (world from camera), moved as c <- c + dc and R_wc <-
exp(dw) R_wc (Kanatani, "Bundle adjustment for 3-D reconstruction"); the
cost is the sum of squared pixel errors. An iteration linearizes at the
current estimate and tries damped steps, the diagonal of the normal
equations multiplied by (1 + c): it accepts the first that lowers the
cost and divides c by 10; otherwise it multiplies c by 10 and tries again.
It stops after ``max_iters`` accepted steps, where a rejected step changes
the cost by no more than 32 ulps of it (converged at the type's
precision), or where c passes ``max_factor`` (failure). c starts at 1e-4.

A damped step eliminates each point by its own 3x3 block V_i: S = U -
sum_i W_i^T V_i^-1 W_i over the cameras' free variables, a dense matrix
factored by Cholesky, then each point's step by back-substitution. No band
plan, no padding, no device loop, no batching: each S block is the sum
over the pairs of observations that share a point.

Departure from the published description: the gauge. Fixed variables are
left out of S rather than fixed by the scene normalization alone; the
caller names them (``free``), and ``normalize`` / ``revert`` give
Kanatani's normalized world (the first camera at the origin, unrotated,
one component of the second camera's position 1) for a global adjustment.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import centres, rodrigues, skew

INITIAL_FACTOR = 1e-4
EPS_FLOOR_ULPS = 32.0


class Problem(NamedTuple):
    K: torch.Tensor        # (fx, fy, cx, cy)
    pt: torch.Tensor       # [O] point of each observation
    cam: torch.Tensor      # [O] camera of each observation
    pix: torch.Tensor      # [O, 2] observed pixels
    free: torch.Tensor     # [C, 6] free camera variables (dc, dw)
    pairs: tuple           # (a, b): observation pairs that share a point


def problem(K, pt, cam, pix, free) -> Problem:
    """The problem's observations; ``pairs`` lists every ordered pair of
    observations of one point (each with itself too)."""
    order = torch.argsort(pt, stable=True)
    counts = torch.bincount(pt, minlength=int(pt.max()) + 1)
    start = torch.cumsum(counts, 0) - counts
    a, b = [], []
    for n in torch.unique(counts[counts > 0]).tolist():
        first = start[counts == n]
        slots = first[:, None] + torch.arange(n, device=pt.device)
        ia, ib = torch.meshgrid(torch.arange(n, device=pt.device),
                                torch.arange(n, device=pt.device),
                                indexing="ij")
        a.append(order[slots[:, ia.reshape(-1)]].reshape(-1))
        b.append(order[slots[:, ib.reshape(-1)]].reshape(-1))
    return Problem(K, pt, cam, pix, free, (torch.cat(a), torch.cat(b)))


def _linearize(pb: Problem, X, R, t):
    """Residuals [O, 2] and the Jacobians [O, 2, 3] of each observation in
    its point and [O, 2, 6] in its camera's (dc, dw), fixed ones zeroed."""
    K = pb.K
    Ro, Xo = R[pb.cam], X[pb.pt]
    xc = (Ro @ Xo[..., None])[..., 0] + t[pb.cam]
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    r = torch.stack([K[0] * x / z + K[2], K[1] * y / z + K[3]], -1) - pb.pix
    dproj = torch.zeros(xc.shape[0], 2, 3, dtype=X.dtype, device=X.device)
    dproj[:, 0, 0] = K[0] / z
    dproj[:, 1, 1] = K[1] / z
    dproj[:, 0, 2] = -K[0] * x / (z * z)
    dproj[:, 1, 2] = -K[1] * y / (z * z)
    JX = dproj @ Ro
    # x_c = R (X - c): d/dc = -R; R <- R exp(-dw): d/dw = R [X - c]x
    d = Xo - centres(R, t)[pb.cam]
    Jc = torch.cat([-JX, JX @ skew(d)], dim=-1)
    Jc = Jc * pb.free[pb.cam][:, None, :].to(X.dtype)
    return r, JX, Jc


def _blocks(pb: Problem, X, R, t):
    r, JX, Jc = _linearize(pb, X, R, t)
    P, C = X.shape[0], R.shape[0]
    V = X.new_zeros(P, 3, 3).index_add_(0, pb.pt, JX.transpose(1, 2) @ JX)
    U = X.new_zeros(C, 6, 6).index_add_(0, pb.cam, Jc.transpose(1, 2) @ Jc)
    gX = X.new_zeros(P, 3).index_add_(
        0, pb.pt, (JX.transpose(1, 2) @ r[..., None])[..., 0])
    gc = X.new_zeros(C, 6).index_add_(
        0, pb.cam, (Jc.transpose(1, 2) @ r[..., None])[..., 0])
    W = JX.transpose(1, 2) @ Jc                                 # [O, 3, 6]
    return V, U, W, gX, gc


def _damp(M: torch.Tensor, c: float) -> torch.Tensor:
    return M + c * torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))


def _step(pb: Problem, blocks, c: float):
    """The damped step (dX [P, 3], dcam [C, 6]) and whether it solved."""
    V, U, W, gX, gc = blocks
    C = U.shape[0]
    Vinv, info_V = torch.linalg.inv_ex(_damp(V, c))
    Y = Vinv[pb.pt] @ W                                        # [O, 3, 6]
    a, b = pb.pairs
    S4 = U.new_zeros(C * C, 6, 6)
    S4.index_add_(0, pb.cam[a] * C + pb.cam[b],
                  W[a].transpose(1, 2) @ Y[b])
    S = -S4.reshape(C, C, 6, 6).permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    S = S + torch.block_diag(*_damp(U, c))
    vX = (Vinv @ gX[..., None])[..., 0]                        # V^-1 gX
    rhs = -gc + U.new_zeros(C, 6).index_add_(
        0, pb.cam, (W.transpose(1, 2) @ vX[pb.pt][..., None])[..., 0])
    free = torch.nonzero(pb.free.reshape(-1))[:, 0]
    L, info = torch.linalg.cholesky_ex(S[free][:, free])
    dfree = torch.cholesky_solve(rhs.reshape(-1)[free][:, None], L)[:, 0]
    dcam = U.new_zeros(6 * C).index_copy_(0, free, dfree).reshape(C, 6)
    Wd = (W @ dcam[pb.cam][..., None])[..., 0]
    dX = -(Vinv @ (gX + gX.new_zeros(gX.shape).index_add_(0, pb.pt, Wd))
           [..., None])[..., 0]
    ok = ((info == 0) & torch.all(info_V == 0) & torch.isfinite(dX).all()
          & torch.isfinite(dcam).all())
    return dX, dcam, bool(ok)


def apply_step(X, R, t, dX, dcam):
    """c <- c + dc, R_wc <- exp(dw) R_wc: R <- R exp(dw)^T (so that a step
    of zero leaves a pose rounded to a lower precision as it is)."""
    c = centres(R, t) + dcam[:, :3]
    R = R @ rodrigues(dcam[:, 3:]).transpose(1, 2)
    return X + dX, R, -(R @ c[..., None])[..., 0]


def cost(pb: Problem, X, R, t) -> float:
    r = _linearize(pb, X, R, t)[0]
    return float(torch.sum(r * r))


class Result(NamedTuple):
    X: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    ok: bool
    iterations: int
    cost: float


def levenberg_marquardt(pb: Problem, X, R, t, max_iters: int,
                        max_factor: float = 1e12) -> Result:
    err = cost(pb, X, R, t)
    floor = EPS_FLOOR_ULPS * torch.finfo(X.dtype).eps
    c = INITIAL_FACTOR
    for it in range(max_iters):
        blocks = _blocks(pb, X, R, t)
        while True:
            dX, dcam, ok = _step(pb, blocks, c)
            if ok:
                X1, R1, t1 = apply_step(X, R, t, dX, dcam)
                err1 = cost(pb, X1, R1, t1)
                ok = err1 == err1 and abs(err1) != float("inf")
            if ok and err1 < err:
                X, R, t, err = X1, R1, t1, err1
                c /= 10.0
                break
            if ok and 0.0 <= err1 - err <= floor * err:
                return Result(X, R, t, True, it, err)
            c *= 10.0
            if c > max_factor:
                return Result(X, R, t, False, it, err)
    return Result(X, R, t, True, max_iters, err)


def normalize(X, R, t, uci: int):
    """Kanatani's normalized world: the first camera at the origin and
    unrotated, the second camera's position component ``uci`` of size 1.
    Returns (X, R, t, gauge)."""
    R0, t0 = R[0], t[0]
    t01 = t0 - R0 @ (R[1].T @ t[1])            # camera 1's centre in camera 0
    s = 1.0 / torch.abs(t01[uci])
    Rn = R @ R0.T
    tn = (t - (Rn @ t0[:, None])[..., 0]) * s
    Xn = (X @ R0.T + t0) * s
    return Xn, Rn, tn, (R0, t0, s)


def revert(X, R, t, gauge):
    R0, t0, s = gauge
    Rw = R @ R0
    tw = t / s + (R @ t0[:, None])[..., 0]
    return (X / s - t0) @ R0, Rw, tw
