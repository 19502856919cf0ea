"""Fake perception backend for virtual scenes: projects the ground-truth 3D
points through the ground-truth camera, with configurable fault injection.

Port of ``surikatoko_tpu/world/demo_matcher.py`` (reference
``DemoCornersMatcher``, demo-davison-mono-slam.cpp:226-424): the strategy
seam that lets the whole EKF run closed loop against known truth. Knobs:
detection noise std (:287-297), match drop probability (:326-332), cap on
new landmarks per frame (:361-371), GT inverse depth for perfect
initialization (:418), and observation suppression (the 's' hotkey).

A host-side stateful object (slot <-> fragment bookkeeping in numpy). The GT
points are projected on the filter's device and read to the host once per
call; the numpy ``default_rng(seed)`` is drawn in the JAX package's order,
so whole runs of the two packages compare frame by frame. Each transfer
that waits for the card (a read, or a copy from pageable host memory to
the card) is a "host_read" span of ``utils.profiling``; the calls are the
spans "matcher.match", "matcher.recruit" and "matcher.book".
"""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch.geom import camera as cam_mod
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
from surikatoko_tpu_torch.models.monoslam.state import MonoSlamState
from surikatoko_tpu_torch.utils.profiling import span


class DemoCornersMatcher:
    def __init__(
        self,
        tracker: MonoSlamFilter,
        gt_cfw: SE3,                 # [F] GT camera-from-tracker poses
        gt_points,                   # [N,3] GT points in the tracker frame
        image_size: tuple[int, int] = (320, 240),
        *,
        detection_noise_std: float = 0.0,
        match_drop_prob: float = 0.0,
        max_new_per_frame: int | None = None,
        max_new_in_first_frame: int | None = None,
        provide_gt_inv_depth: bool = True,
        seed: int = 0,
    ):
        self.tracker = tracker
        self.gt_cfw = gt_cfw
        dev, dtype = tracker.device, tracker.dtype
        self._R = torch.as_tensor(gt_cfw.R, dtype=dtype, device=dev)
        self._t = torch.as_tensor(gt_cfw.t, dtype=dtype, device=dev)
        self.gt_points = np.array(
            gt_points.cpu().numpy() if isinstance(gt_points, torch.Tensor)
            else gt_points, float)
        self._pts = torch.as_tensor(self.gt_points, dtype=dtype, device=dev)
        self.image_size = image_size
        self.detection_noise_std = detection_noise_std
        self.match_drop_prob = match_drop_prob
        self.max_new = max_new_per_frame or tracker.max_new_per_frame
        # reference monoslam_max_new_blobs_in_first_frame vs _per_frame: the
        # bootstrap frame gets its own budget
        self.max_new_first = (max_new_in_first_frame
                              if max_new_in_first_frame is not None
                              else self.max_new)
        self.provide_gt_inv_depth = provide_gt_inv_depth
        self.rng = np.random.default_rng(seed)
        self.suppress_observations = False   # the 's' hotkey fault injection
        # slot -> fragment id (-1 = free); fragment -> slot
        self.slot_to_frag = np.full(tracker.capacity, -1, np.int64)
        self.frag_to_slot = np.full(len(self.gt_points), -1, np.int64)

    # ---- internals -------------------------------------------------------
    def _project_frame(self, frame_ind: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(pixels [N,2], visible [N], inverse distance [N]) of all GT
        points in the GT camera: one projection on the device, one read."""
        x_cam = self._pts @ self._R[frame_ind].T + self._t[frame_ind]
        params = self.tracker.params
        dist = params.dist if params.enable_distortion else None
        pix = cam_mod.project_camera_point(params.cam, dist, x_cam)
        inv_d = 1.0 / torch.clamp(torch.linalg.norm(x_cam, dim=-1), min=1e-12)
        out = torch.cat([pix, x_cam[:, 2:3], inv_d[:, None]], dim=1)
        with span("host_read"):
            out = out.cpu().numpy()
        pix, z, inv_d = out[:, 0:2], out[:, 2], out[:, 3]
        w, h = self.image_size
        inside = ((pix[:, 0] >= 0) & (pix[:, 0] < w) & (pix[:, 1] >= 0)
                  & (pix[:, 1] < h))
        return pix, (z > 1e-6) & inside & np.isfinite(pix).all(axis=1), inv_d

    def _to_device(self, *arrays):
        """The arrays on the device, one copy each (from pageable memory:
        each waits for the card)."""
        dev, dtype = self.tracker.device, self.tracker.dtype
        out = []
        for a in arrays:
            with span("host_read"):
                out.append(torch.as_tensor(
                    a, device=dev,
                    dtype=torch.bool if a.dtype == bool else dtype))
        return tuple(out)

    def _active(self, state: MonoSlamState) -> np.ndarray:
        """The slots' active flags, read to the host."""
        with span("host_read"):
            return state.lm_active.cpu().numpy()

    # ---- the CornersMatcherBase interface --------------------------------
    def match_salient_points(self, state: MonoSlamState, frame_ind: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """(obs [K,2], obs_mask [K]) for the currently tracked slots."""
        with span("matcher.match"):
            K = self.tracker.capacity
            obs = np.zeros((K, 2))
            mask = np.zeros(K, bool)
            if self.suppress_observations:
                return self._to_device(obs, mask)
            pix, visible, _ = self._project_frame(frame_ind)
            active = self._active(state)
            for slot in np.nonzero(active)[0]:
                frag = self.slot_to_frag[slot]
                if frag < 0 or not visible[frag]:
                    continue
                if (self.match_drop_prob > 0
                        and self.rng.uniform() < self.match_drop_prob):
                    continue
                p = pix[frag]
                if self.detection_noise_std > 0:
                    p = p + self.rng.normal(scale=self.detection_noise_std,
                                            size=2)
                obs[slot] = p
                mask[slot] = True
            return self._to_device(obs, mask)

    def recruit_new_salient_points(
        self, state: MonoSlamState, frame_ind: int, obs_mask
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.ndarray]:
        """(new_pix [M,2], new_mask [M], gt_inv_dist [M], frag_ids [M]).

        Picks visible GT fragments not yet tracked, up to the per-frame cap
        (the first-frame cap on frame 0) and the free-slot budget. Padded
        to the larger of the two caps, so shapes stay fixed."""
        with span("matcher.recruit"):
            M = max(self.max_new, self.max_new_first)
            cap = self.max_new_first if frame_ind == 0 else self.max_new
            new_pix = np.zeros((M, 2))
            new_mask = np.zeros(M, bool)
            gt_rho = np.full(M, np.nan)
            frag_out = np.full(M, -1, np.int64)
            if self.suppress_observations:
                return (*self._to_device(new_pix, new_mask, gt_rho), frag_out)
            pix, visible, inv_d = self._project_frame(frame_ind)
            free_slots = int(np.sum(~self._active(state)))
            budget = min(cap, free_slots)
            chosen = np.nonzero(visible & (self.frag_to_slot < 0))[0][:budget]
            if len(chosen) and self.provide_gt_inv_depth:
                gt_rho[: len(chosen)] = inv_d[chosen]
            if self.detection_noise_std > 0 and len(chosen):
                noise = self.rng.normal(scale=self.detection_noise_std,
                                        size=(len(chosen), 2))
            else:
                noise = 0.0
            new_pix[: len(chosen)] = pix[chosen] + noise
            new_mask[: len(chosen)] = True
            frag_out[: len(chosen)] = chosen
            return (*self._to_device(new_pix, new_mask, gt_rho), frag_out)

    def gt_state_for_reset(self, state: MonoSlamState, frame_ind: int
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(gt_pix [K,2], gt_rho [K], slot_mask [K]) for
        ``health.reset_state_to_gt``: the GT projection and inverse distance
        of every tracked slot at ``frame_ind``, visible or not (the
        reference's gt_sal_pnt_in_camera_fun, demo-davison-mono-slam.cpp:
        1540-1552)."""
        K = self.tracker.capacity
        pix = np.zeros((K, 2))
        rho = np.full(K, 1.0)
        mask = np.zeros(K, bool)
        all_pix, _, inv_d = self._project_frame(frame_ind)
        active = self._active(state)
        for slot in np.nonzero(active)[0]:
            frag = self.slot_to_frag[slot]
            if frag < 0:
                continue
            pix[slot] = all_pix[frag]
            rho[slot] = inv_d[frag]
            mask[slot] = True
        return pix, rho, mask

    def on_landmarks_added(self, slots, frag_ids: np.ndarray,
                           state: MonoSlamState) -> None:
        """Record the slots ``add_landmarks`` gave the recruits."""
        with span("matcher.book"):
            if isinstance(slots, torch.Tensor):
                with span("host_read"):
                    slots = slots.cpu().numpy()
            for s, f in zip(np.asarray(slots), frag_ids):
                if s >= 0 and f >= 0:
                    self.slot_to_frag[s] = f
                    self.frag_to_slot[f] = s

    def sync_removed(self, state: MonoSlamState) -> None:
        """Release the bookkeeping of slots the filter deactivated."""
        with span("matcher.book"):
            active = self._active(state)
            for slot in np.nonzero(~active & (self.slot_to_frag >= 0))[0]:
                frag = self.slot_to_frag[slot]
                self.slot_to_frag[slot] = -1
                if frag >= 0:
                    self.frag_to_slot[frag] = -1
