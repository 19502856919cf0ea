"""SE(3) and Sim(3) pose-graph optimization.

Port of ``surikatoko_tpu/models/posegraph.py``. The reference has only
implicit odometry chains; this module optimizes keyframe poses against
relative-pose constraints (odometry + loop closures):

  minimize  sum_e || w_e * log( Z_e^-1 * T_i^-1 * T_j ) ||^2

with T = world-from-keyframe, Z_e the measured j-from-i relative transform,
log the SE(3) right-translation residual split into (rotation log, position
difference in frame i). Levenberg-Marquardt with Jacobians by
``torch.func.jacfwd`` over local increments (left-multiplied se(3) twists),
gauge fixed by pinning pose 0 (the unit-diagonal masking trick used across
the framework). Edges are a masked array of fixed size.

Both LM forms of the JAX package are here: the host schedule (a blocking
error read per attempt) and ``device_loop=True``, which runs
models/ba/lm_device.run_lm_on_device (a host loop with one packed read per
trial and the linearization kept across damping retries).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom import so3
from surikatoko_tpu_torch.models.ba import lm_device
from surikatoko_tpu_torch.ops.transfer import host, send
from surikatoko_tpu_torch.utils.profiling import spanned


class PoseGraph(NamedTuple):
    R: torch.Tensor          # [N,3,3] world-from-keyframe rotations
    t: torch.Tensor          # [N,3] keyframe positions
    edge_i: torch.Tensor     # [E] int64 source pose index
    edge_j: torch.Tensor     # [E] int64 target pose index
    rel_R: torch.Tensor      # [E,3,3] measured R_i^-1 R_j
    rel_t: torch.Tensor      # [E,3] measured t_ij in frame i
    weight: torch.Tensor     # [E] scalar edge weights
    mask: torch.Tensor       # [E] valid edges


def make_pose_graph(R, t, edges, *, device: torch.device | str = "cuda",
                    dtype: torch.dtype | None = None) -> PoseGraph:
    """edges: list of (i, j, rel_R [3,3], rel_t [3], weight). The graph's
    tensors go to ``device`` (the card unless the caller says otherwise) in
    ``dtype`` (default ``config.default_dtype(device)``)."""
    dtype = dtype or config.default_dtype(device)
    R, t, ei, ej, rR, rt, w = send(
        device, dtype, R, t, [e[0] for e in edges], [e[1] for e in edges],
        np.stack([host(e[2]) for e in edges]),
        np.stack([host(e[3]) for e in edges]),
        [e[4] if len(e) > 4 else 1.0 for e in edges])
    return PoseGraph(
        R=R, t=t, edge_i=ei.to(torch.int64), edge_j=ej.to(torch.int64),
        rel_R=rR, rel_t=rt, weight=w,
        mask=torch.ones((len(edges),), dtype=torch.bool, device=device))


def edge_residuals(g: PoseGraph, dw: torch.Tensor, dt: torch.Tensor
                   ) -> torch.Tensor:
    """[E,6] residuals at local increments (dw, dt) [N,3] each (zeros at the
    linearization point): rotation-log and frame-i translation errors."""
    R = so3.exp(dw) @ g.R
    t = g.t + dt
    Ri, Rj = R[g.edge_i], R[g.edge_j]
    ti, tj = t[g.edge_i], t[g.edge_j]
    R_ij = torch.einsum("eab,eac->ebc", Ri, Rj)          # Ri^T Rj
    t_ij = torch.einsum("eab,ea->eb", Ri, tj - ti)       # Ri^T (tj - ti)
    dR = torch.einsum("eab,eac->ebc", g.rel_R, R_ij)     # Z_R^T R_ij
    r = torch.cat([so3.log(dR), t_ij - g.rel_t], dim=-1)
    return r * (g.weight * g.mask.to(r.dtype))[:, None]


def graph_error(g: PoseGraph) -> torch.Tensor:
    z = torch.zeros_like(g.t)
    r = edge_residuals(g, z, z)
    return torch.sum(r * r)


def _free_mask(N: int, dtype, device, sim3: bool) -> torch.Tensor:
    """1 on the free variables, 0 on node 0's (its rotation at 0:3, its
    translation at 3N:3N+3, and for Sim(3) its log-scale at 6N)."""
    free = torch.ones((7 * N if sim3 else 6 * N,), dtype=dtype, device=device)
    free[0:3] = 0.0
    free[3 * N:3 * N + 3] = 0.0
    if sim3:
        free[6 * N] = 0.0
    return free


def _linearize(g: PoseGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """Residuals r [m] and Jacobian J [m, 6N] at the current poses, with
    pose-0 columns zeroed (gauge pin)."""
    N = g.R.shape[0]
    z = torch.zeros((N, 3), dtype=g.t.dtype, device=g.t.device)

    def res_flat(dw, dt):
        return edge_residuals(g, dw, dt).reshape(-1)

    r = res_flat(z, z)
    Jw, Jt = jacfwd(res_flat, argnums=(0, 1))(z, z)
    J = torch.cat([Jw.reshape(r.shape[0], -1),
                   Jt.reshape(r.shape[0], -1)], dim=1)          # [m, 6N]
    return r, J * _free_mask(N, z.dtype, z.device, sim3=False)[None, :]


def _solve_damped(blocks, lam: float, sim3: bool) -> torch.Tensor:
    """-(JᵀJ + λI + pin-diag)⁻¹ Jᵀr: one damped GN step. No error check:
    a singular system gives non-finite entries, which the LM rejects."""
    r, J = blocks
    n = J.shape[1]
    N = n // (7 if sim3 else 6)
    free = _free_mask(N, J.dtype, J.device, sim3)
    H = J.T @ J + (lam + 1e-12) * torch.eye(n, dtype=J.dtype, device=J.device)
    H = H + torch.diag(1.0 - free)       # unit diagonal on pinned vars
    return -torch.linalg.solve_ex(H, (J.T @ r)[:, None])[0][:, 0]


def _apply_step(g: PoseGraph, d: torch.Tensor) -> PoseGraph:
    N = g.R.shape[0]
    dw = d[: 3 * N].reshape(N, 3)
    dt = d[3 * N:].reshape(N, 3)
    return g._replace(R=so3.exp(dw) @ g.R, t=g.t + dt)


class Sim3Graph(NamedTuple):
    """Sim(3) pose graph: nodes are world-from-keyframe SIMILARITIES
    (R, t, s), the standard mechanism for monocular loop closure, where
    pure SE(3) graphs cannot absorb accumulated SCALE drift (Strasdat et
    al., "Scale Drift-Aware Large Scale Monocular SLAM", RSS 2010). The
    reference has no loop-closure machinery at all."""

    R: torch.Tensor          # [N,3,3]
    t: torch.Tensor          # [N,3]
    s: torch.Tensor          # [N] per-keyframe scale
    edge_i: torch.Tensor     # [E]
    edge_j: torch.Tensor     # [E]
    rel_R: torch.Tensor      # [E,3,3] measured R of S_i^-1 S_j
    rel_t: torch.Tensor      # [E,3]
    rel_s: torch.Tensor      # [E] measured scale of S_i^-1 S_j
    weight: torch.Tensor     # [E]
    mask: torch.Tensor       # [E]


def sim3_compose(a, b):
    """(s,R,t) tuples of host arrays: a ∘ b (apply b then a)."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta)


def sim3_inverse(a):
    s, R, t = a
    return (1.0 / s, R.T, -(R.T @ t) / s)


def make_sim3_graph(R, t, edges, s=None, *,
                    device: torch.device | str = "cuda",
                    dtype: torch.dtype | None = None) -> Sim3Graph:
    """edges: list of (i, j, rel_R, rel_t, rel_s, weight). Odometry edges
    use rel_s = 1 (no scale change measured along the chain). On
    ``device`` (the card by default) in ``dtype`` (default
    ``config.default_dtype(device)``)."""
    dtype = dtype or config.default_dtype(device)
    R, t, s, ei, ej, rR, rt, rs, w = send(
        device, dtype, R, t, np.ones(np.shape(R)[0]) if s is None else s,
        [e[0] for e in edges], [e[1] for e in edges],
        np.stack([host(e[2]) for e in edges]),
        np.stack([host(e[3]) for e in edges]),
        [float(e[4]) for e in edges],
        [e[5] if len(e) > 5 else 1.0 for e in edges])
    return Sim3Graph(
        R=R, t=t, s=s, edge_i=ei.to(torch.int64), edge_j=ej.to(torch.int64),
        rel_R=rR, rel_t=rt, rel_s=rs, weight=w,
        mask=torch.ones((len(edges),), dtype=torch.bool, device=device))


def sim3_edge_residuals(g: Sim3Graph, dw, dt, dls) -> torch.Tensor:
    """[E,7] residuals of S_i^-1 S_j vs the measurement at local increments
    (dw,dt [N,3], dls [N]): rotation log, frame-i translation difference,
    log-scale difference."""
    R = so3.exp(dw) @ g.R
    t = g.t + dt
    s = g.s * torch.exp(dls)
    Ri, Rj = R[g.edge_i], R[g.edge_j]
    ti, tj = t[g.edge_i], t[g.edge_j]
    si, sj = s[g.edge_i], s[g.edge_j]
    R_ij = torch.einsum("eab,eac->ebc", Ri, Rj)
    t_ij = torch.einsum("eab,ea->eb", Ri, tj - ti) / si[:, None]
    r_rot = so3.log(torch.einsum("eab,eac->ebc", g.rel_R, R_ij))
    r_trn = t_ij - g.rel_t
    r_scl = (torch.log(sj) - torch.log(si) - torch.log(g.rel_s))[:, None]
    r = torch.cat([r_rot, r_trn, r_scl], dim=-1)
    return r * (g.weight * g.mask.to(r.dtype))[:, None]


def sim3_graph_error(g: Sim3Graph) -> torch.Tensor:
    z = torch.zeros_like(g.t)
    r = sim3_edge_residuals(g, z, z, torch.zeros_like(g.s))
    return torch.sum(r * r)


def _sim3_linearize(gc: Sim3Graph):
    N = gc.R.shape[0]
    z3 = torch.zeros((N, 3), dtype=gc.t.dtype, device=gc.t.device)
    z1 = torch.zeros((N,), dtype=gc.t.dtype, device=gc.t.device)

    def res_flat(dw, dt, dls):
        return sim3_edge_residuals(gc, dw, dt, dls).reshape(-1)

    r = res_flat(z3, z3, z1)
    Jw, Jt, Js = jacfwd(res_flat, argnums=(0, 1, 2))(z3, z3, z1)
    J = torch.cat([Jw.reshape(r.shape[0], -1),
                   Jt.reshape(r.shape[0], -1),
                   Js.reshape(r.shape[0], -1)], dim=1)          # [m,7N]
    return r, J * _free_mask(N, z3.dtype, z3.device, sim3=True)[None, :]


def _sim3_apply_step(gc: Sim3Graph, d) -> Sim3Graph:
    N = gc.R.shape[0]
    dw = d[:3 * N].reshape(N, 3)
    dt = d[3 * N:6 * N].reshape(N, 3)
    dls = d[6 * N:]
    return gc._replace(R=so3.exp(dw) @ gc.R, t=gc.t + dt,
                       s=gc.s * torch.exp(dls))


def _optimize(g, *, linearize, apply_step, error, sim3: bool, iters: int,
              damping: float, max_damping: float, device_loop: bool):
    """The LM of both graphs: the framework's x10/÷10 schedule (the BA
    loop's, reference bundle-adj-kanatani.cpp:841,:889) with λ floored at
    ``damping``; a rejected step raises λ and retries, until λ passes
    ``max_damping``."""
    if device_loop:
        def solve_fn(_p, blocks, factor):
            d = _solve_damped(blocks, max(factor, damping), sim3)
            return d, torch.zeros((), dtype=d.dtype, device=d.device), \
                torch.isfinite(d).all()

        g_out, _code, _iters, _err, _tr = lm_device.run_lm_on_device(
            g, blocks_fn=linearize, solve_fn=solve_fn,
            apply_fn=lambda p, dX, _du: apply_step(p, dX),
            err_fn=error, err_thresh=None, max_factor=max_damping,
            max_iters=iters, initial_factor=damping, name="posegraph")
        return g_out

    lam = damping
    err = float(error(g))
    for _ in range(iters):
        g_try = apply_step(g, _solve_damped(linearize(g), lam, sim3))
        err_try = float(error(g_try))
        if err_try < err:
            g, err = g_try, err_try
            lam = max(lam / 10.0, damping)
        else:
            lam *= 10.0
            if lam > max_damping:
                break
    return g


@spanned("posegraph.sim3")
def optimize_sim3_graph(g: Sim3Graph, iters: int = 30,
                        damping: float = 1e-6,
                        max_damping: float = 1e8,
                        device_loop: bool = False) -> Sim3Graph:
    """LM over (R, t, log s) of all nodes; node 0 pinned (full Sim(3)
    gauge: orientation, position, AND global scale).

    ``device_loop=True`` runs the BA's device-loop LM
    (models/ba/lm_device.py): one packed read per trial instead of the host
    schedule's read per attempt, and the linearization is kept across
    damping retries, where the host schedule re-linearizes. A call is the
    span ``posegraph.sim3``."""
    return _optimize(g, linearize=_sim3_linearize,
                     apply_step=_sim3_apply_step, error=sim3_graph_error,
                     sim3=True, iters=iters, damping=damping,
                     max_damping=max_damping, device_loop=device_loop)


def optimize_pose_graph(g: PoseGraph, iters: int = 20,
                        damping: float = 1e-6,
                        max_damping: float = 1e8,
                        device_loop: bool = False) -> PoseGraph:
    """Levenberg-Marquardt over all poses; pose 0 pinned (gauge).

    A rejected step raises lambda and retries from the same linearization,
    so far-from-linear initializations (large loop-closure residuals)
    converge instead of stalling on the first overshoot. ``device_loop``
    as in :func:`optimize_sim3_graph`."""
    return _optimize(g, linearize=_linearize, apply_step=_apply_step,
                     error=graph_error, sim3=False, iters=iters,
                     damping=damping, max_damping=max_damping,
                     device_loop=device_loop)
