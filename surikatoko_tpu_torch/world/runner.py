"""Closed-loop virtual-scenario loop: the demo main loop
(demo-davison-mono-slam.cpp:1686-1942) as a reusable function, with its GT
pose helpers.

Port of ``surikatoko_tpu/world/runner.py``: ``ScenarioResult``,
``init_tracker_state_from_gt``, ``gt_poses_in_tracker_frame``,
``run_scenario``, ``run_image_sequence``, ``run_image_sequence_pipelined``
and ``camera_orientation_error_deg``. The matcher runs on the host between
filter steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surikatoko_tpu_torch.geom import quat as quat_mod
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
from surikatoko_tpu_torch.models.monoslam.state import MonoSlamState
from surikatoko_tpu_torch.utils.profiling import span


class ScenarioResult(NamedTuple):
    state: MonoSlamState
    stats: list
    cam_pos_err: np.ndarray       # [F] |r_est - r_gt|
    cam_pos_gt: np.ndarray        # [F,3]
    cam_pos_est: np.ndarray       # [F,3]


def init_tracker_state_from_gt(tracker: MonoSlamFilter, gt_cfw: SE3,
                               dt: float = 1.0,
                               with_velocity: bool = True,
                               with_ang_velocity: bool | None = None,
                               ) -> MonoSlamState:
    """The first camera anchors the tracker frame (identity pose, zero
    covariance); optionally seeded with the GT initial linear and angular
    velocity (the reference's monoslam_cam_perfect_init_vel / _ang_vel,
    demo-davison-mono-slam.cpp:1497-1506)."""
    from surikatoko_tpu_torch.world import scene_gen
    if with_ang_velocity is None:
        with_ang_velocity = with_velocity
    kwargs = {}
    if (with_velocity or with_ang_velocity) and gt_cfw.t.shape[0] >= 2:
        R = torch.as_tensor(gt_cfw.R[:2], dtype=torch.float64).cpu()
        t = torch.as_tensor(gt_cfw.t[:2], dtype=torch.float64).cpu()
        v, w = scene_gen.initial_camera_motion(SE3(R[0], t[0]), SE3(R[1], t[1]),
                                               dt)
        if with_velocity:
            kwargs["cam_vel"] = v.tolist()
        if with_ang_velocity:
            kwargs["cam_ang_vel"] = w.tolist()
    return tracker.init_state(**kwargs)


def gt_poses_in_tracker_frame(gt_cfw: SE3) -> SE3:
    """Re-express GT camera poses relative to the first camera: the tracker
    origin is camera 0 (reference kTrackerOriginCamInd=0,
    demo-davison-mono-slam.cpp:205)."""
    wfT = SE3(gt_cfw.R[0], gt_cfw.t[0]).inv()
    R = torch.einsum("fij,jk->fik", gt_cfw.R, wfT.R)
    t = torch.einsum("fij,j->fi", gt_cfw.R, wfT.t) + gt_cfw.t
    return SE3(R, t)


def run_scenario(tracker: MonoSlamFilter, matcher, gt_cfw_tracker: SE3,
                 n_frames: int | None = None,
                 state: MonoSlamState | None = None) -> ScenarioResult:
    """Frames 0 .. n_frames-1: match -> recruit -> filter step -> the
    matcher's slot bookkeeping. Each frame's estimated camera position is
    the updated one (``stats.cam_state``); its GT is the camera centre of
    ``gt_cfw_tracker`` (kept in float64 on the host)."""
    n_frames = n_frames or gt_cfw_tracker.t.shape[0]
    if state is None:
        state = init_tracker_state_from_gt(tracker, gt_cfw_tracker,
                                           dt=float(tracker.params.dt))
    gt_R = torch.as_tensor(gt_cfw_tracker.R, dtype=torch.float64).cpu().numpy()
    gt_t = torch.as_tensor(gt_cfw_tracker.t, dtype=torch.float64).cpu().numpy()
    stats_list, pos_est = [], []
    for f in range(n_frames):
        obs, obs_mask = matcher.match_salient_points(state, f)
        new_pix, new_mask, gt_rho, frag_ids = matcher.recruit_new_salient_points(
            state, f, obs_mask)
        state, stats = tracker.process_frame(state, obs, obs_mask, new_pix,
                                             new_mask, gt_rho)
        matcher.on_landmarks_added(stats.new_slots, frag_ids, state)
        matcher.sync_removed(state)
        stats_list.append(stats)
        pos_est.append(stats.cam_state[0:3])
    pos_est = torch.stack(pos_est).double().cpu().numpy() if pos_est else (
        np.zeros((0, 3)))
    # GT camera centre in the tracker frame: -R^T t of camera-from-tracker
    pos_gt = -np.einsum("fji,fj->fi", gt_R[:n_frames], gt_t[:n_frames])
    err = np.linalg.norm(pos_est - pos_gt, axis=-1)
    return ScenarioResult(state, stats_list, err, pos_gt, pos_est)


def _new_pix_host(matcher, new_pix) -> np.ndarray:
    """Host copy of the recruits ``new_pix`` that recruitment returned:
    the matcher's own copy of that very tensor where it keeps one
    (``host_new_pix``), else a read."""
    host = getattr(matcher, "host_new_pix", None)
    if host is not None:
        return host(new_pix)
    with span("host_read"):
        return new_pix.cpu().numpy()


def run_image_sequence(tracker: MonoSlamFilter, matcher, images,
                       state: MonoSlamState | None = None
                       ) -> tuple[MonoSlamState, list]:
    """Frame loop of the real-image perception path (the reference's
    imageseq scenario): analyze -> match -> recruit -> filter step ->
    template bookkeeping. ``images`` yields [H,W] grayscale frames (numpy
    arrays or host tensors)."""
    if state is None:
        state = tracker.init_state()
    stats_list = []
    for f, img in enumerate(images):
        matcher.analyze_frame(img)
        obs, obs_mask = matcher.match_salient_points(state, f)
        new_pix, new_mask = matcher.recruit_new_salient_points(state, f, obs_mask)
        state, stats = tracker.process_frame(state, obs, obs_mask, new_pix,
                                             new_mask)
        with span("host_read"):
            new_slots = stats.new_slots.cpu().numpy()
        matcher.on_landmarks_added(new_slots, _new_pix_host(matcher, new_pix),
                                   state)
        matcher.sync_removed(state)
        stats_list.append(stats)
    return state, stats_list


def run_image_sequence_pipelined(tracker: MonoSlamFilter, matcher, images,
                                 state: MonoSlamState | None = None
                                 ) -> tuple[MonoSlamState, list]:
    """:func:`run_image_sequence` with the next frame's perception queued
    behind the current filter step; bit for bit the same results, only the
    schedule differs. The host orders each frame so that its one blocking
    read of the step's results comes after the next frame's work that
    needs no state is queued:

      queue the filter step of frame f              [card busy]
      prefetch frame f+1: decode (the loader's thread), upload from pinned
        memory without blocking, queue its Shi-Tomasi pass
      read frame f's new slots and active mask      [first wait]

    so decoding and the host's queueing of frame f+1 overlap the card's
    step f. The reference gets this overlap from a worker/UI thread split
    (demo-davison-mono-slam-ui.h:164). The templates are cut at the
    ``new_pix`` that recruitment returned."""
    if state is None:
        state = tracker.init_state()
    stats_list = []
    it = iter(images)
    cur = next(it, None)
    if cur is None:
        return state, stats_list
    matcher.prefetch_frame(cur)
    f = 0
    while cur is not None:
        matcher.analyze_frame()                 # take the prefetched frame
        obs, obs_mask = matcher.match_salient_points(state, f)
        new_pix, new_mask = matcher.recruit_new_salient_points(state, f, obs_mask)
        state, stats = tracker.process_frame(state, obs, obs_mask, new_pix,
                                             new_mask)
        cur = next(it, None)
        if cur is not None:                     # overlaps the step above
            matcher.prefetch_frame(cur)
        # one read for the frame's bookkeeping
        K = state.lm_active.shape[0]
        packed = torch.cat([stats.new_slots.to(torch.int64),
                            state.lm_active.to(torch.int64)])
        with span("host_read"):
            packed = packed.cpu().numpy()
        matcher.on_landmarks_added(packed[:-K], _new_pix_host(matcher, new_pix),
                                   state)
        matcher.sync_removed(state, packed[-K:].astype(bool))
        stats_list.append(stats)
        f += 1
    return state, stats_list


def camera_orientation_error_deg(stats_cam_state, cfw_gt: SE3) -> float:
    """Angle between the estimated and the GT camera orientation, degrees."""
    q_est = torch.as_tensor(stats_cam_state[3:7]).double().cpu()
    R_est = quat_mod.to_rotmat(q_est).numpy()              # wfc estimated
    R_gt = torch.as_tensor(cfw_gt.R).double().cpu().numpy().T   # wfc GT
    c = (np.trace(R_est @ R_gt.T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))
