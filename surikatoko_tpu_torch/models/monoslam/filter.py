"""MonoSlam filter orchestration: the ProcessFrame pipeline as one step.

Port of ``surikatoko_tpu/models/monoslam/filter.py`` (reference
DavisonMonoSlam::ProcessFrame, davison-mono-slam.cpp:842-950). Perception
is split out at the reference's ``CornersMatcherBase`` seam: a matcher runs
on the host between steps against the predicted state and hands
(observations, masks, recruits) to the step:

  match (outside) -> update (1 of 4 impls) -> health -> delete policy ->
  recruit new landmarks -> predict next frame

The held state is the prediction for the frame about to be processed.
``process_frame`` is eager PyTorch on the device of the state with fixed
shapes: no ``.item()``, no ``bool()`` of a tensor and no shape that depends
on data, so a step never waits for the card; the only host reads of a frame
are the matcher's. It returns the new state and a FrameStats slice
(reference DavisonMonoSlamTrackerInternalsSlice, davison-mono-slam.h:332-355).

Differences from the JAX package, by design: P == P^T holds bit for bit
after every step (the downdate kernel mirrors, the sequential updates
symmetrize, new landmarks' blocks are mirrored), and update impls 1 and 4
factor the innovation with ``cholesky_ex``, whose info the step drops as
JAX's silent factorization does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surikatoko_tpu_torch.models.monoslam import health, landmarks, measure
from surikatoko_tpu_torch.models.monoslam import predict as predict_mod
from surikatoko_tpu_torch.models.monoslam import update
from surikatoko_tpu_torch.models.monoslam.state import (
    CAM_STATE_COMPS,
    REPRES_SPHERICAL,
    REPRES_XYZ,
    MonoSlamParams,
    MonoSlamState,
    init_state,
)
from surikatoko_tpu_torch.utils.profiling import span

_N = CAM_STATE_COMPS

UPDATE_IMPLS = {
    1: "stacked",
    2: "one_observation",
    3: "one_component",
    4: "one_point_ransac",
}


class FrameStats(NamedTuple):
    """Per-frame observability slice (reference h:332-355 subset)."""

    frame_ind: torch.Tensor
    obs_count: torch.Tensor          # matched observations used
    new_count: torch.Tensor          # landmarks recruited this frame
    deleted_count: torch.Tensor      # landmarks removed this frame
    estimated_count: torch.Tensor    # active landmarks after the frame
    meas_reproj_err: torch.Tensor    # mean |resid| over matched, before update
    opt_reproj_err: torch.Tensor     # mean |resid| after update
    cam_state: torch.Tensor          # updated camera 13-vector
    cam_pos_cov: torch.Tensor        # [3,3] camera position covariance
    ransac_low: torch.Tensor
    ransac_high: torch.Tensor
    new_slots: torch.Tensor          # [M] slot id per recruit (-1 = not added)


class MonoSlamFilter:
    """Host-side holder of the parameters and the static choices
    (capacity, update impl); the math is in :func:`_process_frame`. The
    state lives on the device and in the dtype of ``params``' tensors."""

    def __init__(self, params: MonoSlamParams, capacity: int,
                 update_impl: int = 1, max_new_per_frame: int = 16):
        if update_impl not in UPDATE_IMPLS:
            raise ValueError(f"unknown update_impl {update_impl}")
        self.params = params
        self.capacity = capacity
        self.update_impl = update_impl
        self.max_new_per_frame = max_new_per_frame

    @property
    def device(self) -> torch.device:
        return self.params.dt.device

    @property
    def dtype(self) -> torch.dtype:
        return self.params.dt.dtype

    def init_state(self, **kwargs) -> MonoSlamState:
        """:func:`state.init_state` at this filter's capacity, on the device
        and in the dtype of ``params``."""
        return init_state(self.capacity, dtype=self.dtype, device=self.device,
                          **kwargs)

    def process_frame(self, state: MonoSlamState,
                      obs: torch.Tensor, obs_mask: torch.Tensor,
                      new_pix: torch.Tensor, new_mask: torch.Tensor,
                      new_gt_inv_dist: torch.Tensor | None = None,
                      ) -> tuple[MonoSlamState, FrameStats]:
        if new_gt_inv_dist is None:
            new_gt_inv_dist = torch.full((new_pix.shape[0],), float("nan"),
                                         dtype=state.x.dtype,
                                         device=state.x.device)
        with span("frame"):
            return _process_frame(self.params, self.update_impl, state, obs,
                                  obs_mask, new_pix, new_mask,
                                  new_gt_inv_dist)

    def predicted_pixels(self, state: MonoSlamState) -> torch.Tensor:
        return measure.project_all(self.params, state.x)

    def predicted_pixel_uncertainty(self, state: MonoSlamState
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean [K,2], cov [K,2,2]) of each slot's projected position under
        the predicted state, measurement noise included (reference
        GetSalientPointProjected2DPosWithUncertainty :3901)."""
        return _predicted_pixel_uncertainty(self.params, state)


def format_state(state: MonoSlamState, max_landmarks: int = 16,
                 sal_pnt_repres: int = REPRES_SPHERICAL) -> str:
    """Human-readable filter dump (reference DumpTrackerState,
    davison-mono-slam.cpp:2162-2267): camera state and, per active
    landmark, its generation, Euclidean position, rho, variance trace and
    unobserved count. Reads the state to the host once."""
    x = state.x.detach().cpu().numpy()
    P = state.P.detach().cpu().numpy()
    active = state.lm_active.cpu().numpy()
    gen = state.lm_generation.cpu().numpy()
    unobs = state.lm_unobserved.cpu().numpy()
    lines = [
        f"frame_ind={int(state.frame_ind)} active_landmarks="
        f"{int(np.sum(active))}/{state.capacity}",
        f"cam r=[{x[0]:+.4f} {x[1]:+.4f} {x[2]:+.4f}] "
        f"q=[{x[3]:+.4f} {x[4]:+.4f} {x[5]:+.4f} {x[6]:+.4f}]",
        f"    v=[{x[7]:+.4f} {x[8]:+.4f} {x[9]:+.4f}] "
        f"w=[{x[10]:+.4f} {x[11]:+.4f} {x[12]:+.4f}]",
        f"    pos var diag=[{P[0, 0]:.3e} {P[1, 1]:.3e} {P[2, 2]:.3e}]",
    ]
    shown = [k for k in range(state.capacity) if active[k]][:max_landmarks]
    lms = torch.as_tensor(x[_N:].reshape(-1, 6))
    pos = measure.landmark_world_pos(lms, repres=sal_pnt_repres).numpy()
    for k in shown:
        off = _N + 6 * k
        var = np.diag(P[off:off + 6, off:off + 6])
        lines.append(
            f"lm[{k}] gen={int(gen[k])} "
            f"xyz=[{pos[k, 0]:+.3f} {pos[k, 1]:+.3f} {pos[k, 2]:+.3f}] "
            f"rho={float(x[off + 5]):.4f} var_tr={var.sum():.3e} "
            f"unobs={int(unobs[k])}")
    if int(np.sum(active)) > len(shown):
        lines.append(f"... and {int(np.sum(active)) - len(shown)} more landmarks")
    return "\n".join(lines)


def _predicted_pixel_uncertainty(params: MonoSlamParams, state: MonoSlamState):
    h, Hcam, Hlm = measure.measurement_jacobians(params, state.x)
    A = update._hp(Hcam, Hlm, state.P)                            # [K,2,D]
    own = update._own_cols(A)                                     # [K,2,6]
    S = (torch.einsum("kid,kjd->kij", A[:, :, :_N], Hcam)
         + torch.einsum("kid,kjd->kij", own, Hlm)
         + params.measurm_noise_var * torch.eye(2, dtype=state.x.dtype,
                                                device=state.x.device))
    return h, S


def _process_frame(params: MonoSlamParams, update_impl: int,
                   state: MonoSlamState, obs, obs_mask, new_pix, new_mask,
                   new_gt_inv_dist) -> tuple[MonoSlamState, FrameStats]:
    dtype, dev = state.x.dtype, state.x.device
    obs = obs.to(dtype=dtype, device=dev)
    obs_mask = obs_mask.to(device=dev) & state.lm_active
    new_pix = new_pix.to(dtype=dtype, device=dev)
    new_mask = new_mask.to(device=dev)
    new_gt_inv_dist = new_gt_inv_dist.to(dtype=dtype, device=dev)
    obs_count = obs_mask.sum(dtype=torch.int32)
    any_obs = obs_count > 0

    # ---- delete policy: long-unobserved landmarks (reference :799-840) ----
    unobs = torch.where(obs_mask, 0,
                        state.lm_unobserved + state.lm_active.to(torch.int32))
    mu = params.max_undetected_frames
    stale = (mu > 0) & (unobs > mu)
    state = state._replace(lm_unobserved=unobs)

    # ---- measurement update (it applies only if anything was observed) ----
    x, P = state.x, state.P
    low = torch.zeros((), dtype=torch.int32, device=dev)
    high = torch.zeros((), dtype=torch.int32, device=dev)
    if update_impl == 1:
        x_u, P_u, resid, _ = update.stacked_update(params, x, P, obs, obs_mask)
    elif update_impl == 2:
        x_u, P_u, resid = update.one_obs_update(params, x, P, obs, obs_mask)
    elif update_impl == 3:
        x_u, P_u, resid = update.one_component_update(params, x, P, obs,
                                                      obs_mask)
    else:
        x_u, P_u, resid, low, high, _ = update.one_point_ransac_update(
            params, x, P, obs, obs_mask)
    x = torch.where(any_obs, x_u, x)
    P = torch.where(any_obs, P_u, P)

    # ---- self-healing (reference :1118-1125) ----
    with span("frame.health"):
        x, P = health.normalize_quat_and_covar(x, P)
        P = health.ensure_nonneg_variance(P)
        rho_sub = params.sal_pnt_negative_inv_rho_substitute
        if params.sal_pnt_repres != REPRES_XYZ:     # rho is spherical-only
            x, _ = health.substitute_negative_inv_rho(x, rho_sub,
                                                      state.capacity)
        bad = health.bad_uncertainty_mask(
            x, P, state.capacity, rho_sub,
            params.sal_pnt_repres) & state.lm_active
        remove = stale | bad
        deleted_count = (remove & state.lm_active).sum(dtype=torch.int32)
        state = landmarks.remove_landmarks(state._replace(x=x, P=P),
                                           remove)

    # ---- post-update residual (optimized reprojection error) ----
    h_after = measure.project_all(params, state.x)
    resid_after = (obs - h_after) * obs_mask[:, None].to(dtype)
    obs_f = torch.clamp(obs_count.to(dtype), min=1)
    meas_err = torch.linalg.norm(resid, dim=-1).sum() / obs_f
    opt_err = torch.linalg.norm(resid_after, dim=-1).sum() / obs_f

    # ---- recruit new landmarks (reference :923 -> :1812) ----
    state, slots = landmarks.add_landmarks(params, state, new_pix, new_mask,
                                           new_gt_inv_dist)
    new_count = (slots >= 0).sum(dtype=torch.int32)

    cam_state = state.x[:_N]
    cam_pos_cov = state.P[:3, :3]
    estimated_count = state.lm_active.sum(dtype=torch.int32)

    # ---- predict the next frame (reference :931) ----
    state = predict_mod.predict(params, state)
    state = state._replace(frame_ind=state.frame_ind + 1)

    stats = FrameStats(
        frame_ind=state.frame_ind - 1, obs_count=obs_count,
        new_count=new_count, deleted_count=deleted_count,
        estimated_count=estimated_count, meas_reproj_err=meas_err,
        opt_reproj_err=opt_err, cam_state=cam_state, cam_pos_cov=cam_pos_cov,
        ransac_low=low, ransac_high=high, new_slots=slots)
    return state, stats
