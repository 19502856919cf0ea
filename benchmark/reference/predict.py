# Frozen copy of the port's surikatoko_tpu_torch/models/monoslam/predict.py (plain PyTorch), imports
# made local: part of the benchmark's reference, which imports nothing of the port.
"""EKF prediction: constant-velocity SE(3) kinematics + covariance propagation.

Port of ``surikatoko_tpu/models/monoslam/predict.py`` (reference
PredictCameraMotionByKinematicModel davison-mono-slam.cpp:583-638 and
PredictEstimVars :639-694). F and G are closed form; the tests check them
against ``torch.func.jacfwd`` of :func:`predict_camera`.
"""

from __future__ import annotations

import torch

from . import quat
from .state import (
    CAM_STATE_COMPS,
    MonoSlamParams,
    MonoSlamState,
)


def predict_camera(params: MonoSlamParams, cam13: torch.Tensor,
                   noise6: torch.Tensor | None = None) -> torch.Tensor:
    """One step of the constant-velocity model; ``noise6`` = [dv(3), dw(3)]."""
    r, q, v, w = cam13[0:3], cam13[3:7], cam13[7:10], cam13[10:13]
    dt = params.dt
    if noise6 is None:
        noise6 = torch.zeros(6, dtype=cam13.dtype, device=cam13.device)
    nv, nw = noise6[0:3], noise6[3:6]
    r_new = r + v * dt + nv * dt
    q_new = quat.mult(q, quat.from_axis_angle(w * dt + nw * dt))
    return torch.cat([r_new, q_new, v + nv, w + nw])


def _quat_left_mat(q: torch.Tensor) -> torch.Tensor:
    """L(q) with L(q) b = q (x) b."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([w, -x, -y, -z, x, w, -z, y,
                        y, z, w, -x, z, -y, x, w]).reshape(4, 4)


def _quat_right_mat(q: torch.Tensor) -> torch.Tensor:
    """R(q) with R(q) a = a (x) q."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([w, -x, -y, -z, x, w, z, -y,
                        y, -z, w, x, z, y, -x, w]).reshape(4, 4)


def _dquat_daxis_angle(u: torch.Tensor) -> torch.Tensor:
    """d(quat.from_axis_angle(u))/du as [4,3] (reference Deriv_q3_by_w :3362)."""
    theta2 = torch.sum(u * u)
    theta = torch.sqrt(theta2 + 1e-24)
    half = 0.5 * theta
    small = theta2 < 1e-8
    s, c = torch.sin(half), torch.cos(half)
    k = torch.where(small, 0.5 - theta2 / 48.0, s / theta)
    coeff = torch.where(small, -1.0 / 24.0 + theta2 / 960.0,
                        (0.5 * c - k) / theta2)
    dw = -0.5 * k * u
    dv = k * torch.eye(3, dtype=u.dtype, device=u.device) + coeff * torch.outer(u, u)
    return torch.cat([dw[None, :], dv], dim=0)


def camera_transition_jacobians(params: MonoSlamParams, cam13: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(F [13,13], G [13,6]) at the current camera state, analytic."""
    dtype, dev = cam13.dtype, cam13.device
    dt = params.dt
    q = cam13[3:7]
    w = cam13[10:13]
    dq = quat.from_axis_angle(w * dt)
    dq_dw = (_quat_left_mat(q) @ _dquat_daxis_angle(w * dt)) * dt
    # assembled from blocks, not written into a fresh eye/zeros: under
    # torch.func.vmap the blocks are batched and a write into an unbatched
    # tensor is refused
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z = lambda r, c: torch.zeros((r, c), dtype=dtype, device=dev)  # noqa: E731
    F = torch.cat([
        torch.cat([eye3, z(3, 4), dt * eye3, z(3, 3)], dim=1),
        torch.cat([z(4, 3), _quat_right_mat(dq), z(4, 3), dq_dw], dim=1),
        torch.cat([z(3, 7), eye3, z(3, 3)], dim=1),
        torch.cat([z(3, 10), eye3], dim=1)])
    G = torch.cat([
        torch.cat([dt * eye3, z(3, 3)], dim=1),
        torch.cat([z(4, 3), dq_dw], dim=1),
        torch.cat([eye3, z(3, 3)], dim=1),
        torch.cat([z(3, 3), eye3], dim=1)])
    return F, G


def camera_congruence_(params: MonoSlamParams, P: torch.Tensor,
                       C: torch.Tensor, G: torch.Tensor) -> None:
    """In place: the 13 camera rows and columns of P become those of
    C P C^T + G Q G^T (the landmark block is untouched). The column stripe
    is the row stripe's transpose, so a symmetric P stays exactly
    symmetric."""
    n = CAM_STATE_COMPS
    Q = params.process_noise_cov.to(P.dtype)
    top = C @ P[:n, :]
    corner = top[:, :n] @ C.T + G @ Q @ G.T
    top[:, :n] = 0.5 * (corner + corner.T)
    P[:n, :] = top
    P[:, :n] = top.T


def predict(params: MonoSlamParams, state: MonoSlamState) -> MonoSlamState:
    """Predict on the full state: only the camera block of x and the camera
    rows/cols of P change."""
    n = CAM_STATE_COMPS
    cam13 = state.x[:n]
    F, G = camera_transition_jacobians(params, cam13)
    P = state.P.clone()
    camera_congruence_(params, P, F, G)
    x_new = torch.cat([predict_camera(params, cam13), state.x[n:]])
    return state._replace(x=x_new, P=P)


def renormalize_and_transition(params: MonoSlamParams, x: torch.Tensor):
    """Quaternion renormalization of x followed by the kinematic predict of
    its camera. Returns (x_next, C = F J_q [13,13] with the renorm's
    Jacobian folded in, G [13,6], renormalized x, J_q [4,4], F [13,13])."""
    n = CAM_STATE_COMPS
    q = x[3:7]
    qn = torch.linalg.norm(q)
    nq = q / qn
    # d(q/|q|)/dq = (I - n n^T)/|q|
    Jq = (torch.eye(4, dtype=x.dtype, device=x.device)
          - torch.outer(nq, nq)) / qn
    x1 = torch.cat([x[:3], nq, x[7:]])
    cam13 = x1[:n]
    F, G = camera_transition_jacobians(params, cam13)
    C = F.clone()
    C[:, 3:7] = F[:, 3:7] @ Jq
    x_next = torch.cat([predict_camera(params, cam13), x1[n:]])
    return x_next, C, G, x1, Jq, F


def normalize_and_predict(params: MonoSlamParams, state: MonoSlamState
                          ) -> MonoSlamState:
    """Quaternion renormalization composed with the kinematic predict as one
    camera-stripe transform of P: both are congruences touching only the 13
    camera variables, so C = F J_q is applied in a single [13,D] pass."""
    x_next, C, G = renormalize_and_transition(params, state.x)[:3]
    P = state.P.clone()
    camera_congruence_(params, P, C, G)
    return state._replace(x=x_next, P=P)
