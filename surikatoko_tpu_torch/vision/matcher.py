"""Real-image perception: template tracking and corner recruitment.

Port of ``surikatoko_tpu/vision/matcher.py`` (reference
``ImageTemplCornersMatcher``, demo-davison-mono-slam.cpp:428-884): each
landmark's template is searched for by NCC inside its predicted
projected-uncertainty ellipse, new Shi-Tomasi corners are recruited away from
the tracked ones, and a template jump can be vetoed.

One batched ellipse-gated search a frame covers every landmark
(ops/ncc.py: kernel B1 on the card, its plain version on the CPU). The
template store lives on the host in numpy (``templates``, ``templ_valid``,
``last_center``), as in the JAX package; the frame, the search and the
detection live on the tracker's device. Each stage reads the card once: the
match stage one packed tensor (matches, centres, telemetry and the free slot
count), the recruit stage one packed tensor (corners, their mask, and the
free count unless the match stage of this frame has it); what a stage sends
to the card goes as one copy from pinned memory, which does not block the
host.

Two faults of the JAX matcher are not copied: the free-count cache is keyed
on a per-frame counter that :meth:`analyze_frame` advances (the JAX matcher
keys it on ``id(state)``, and Python reuses ids), and the recruits' host copy
is handed out only for the very tensor that recruitment returned
(:meth:`host_new_pix`).
"""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch.geom import ellipse as ell_mod
from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
from surikatoko_tpu_torch.models.monoslam.state import MonoSlamState
from surikatoko_tpu_torch.ops import ncc as ncc_mod
from surikatoko_tpu_torch.vision import features, klt


def _host_f32(image) -> np.ndarray:
    """A frame ([H,W] numpy array or host tensor, any dtype) as float32."""
    if isinstance(image, torch.Tensor):
        image = image.numpy()
    return np.asarray(image, np.float32)


class ImageTemplCornersMatcher:
    def __init__(
        self,
        tracker: MonoSlamFilter,
        *,
        templ_width: int = 17,
        search_radius: int = 12,
        min_corr_coeff: float = 0.65,
        min_templ_corr_for_jump_check: float = 0.0,
        max_new_per_frame: int | None = None,
        min_distance_new_to_tracked: float = 20.0,
        detector_max_corners: int = 50,
        ellipse_confidence: float = 0.95,
        max_center_jump_pix: float | None = None,
        min_search_rect: int = 7,
    ):
        self.tracker = tracker
        self.device = tracker.device
        self.templ_width = templ_width
        self.min_corr_coeff = min_corr_coeff
        self.max_new = max_new_per_frame or tracker.max_new_per_frame
        self.min_dist_new = min_distance_new_to_tracked
        self.detector_max_corners = detector_max_corners
        self.max_center_jump_pix = max_center_jump_pix
        chi2 = float(ell_mod.chi_square_quantile_2dof(ellipse_confidence))
        self._search = ncc_mod.make_ncc_search(
            search_radius, min_corr_coeff, chi2_gate=chi2,
            min_search_rect=min_search_rect)
        K = tracker.capacity
        self.templates = np.zeros((K, templ_width, templ_width), np.float32)
        self.templ_valid = np.zeros(K, bool)
        self.last_center = np.zeros((K, 2), np.float32)
        self.suppress_observations = False
        self.executed_match_templ_calls = 0   # search-efficiency counter
        # gate telemetry (reference executed_match_templ_calls,
        # demo-davison-mono-slam.cpp:461): full-window evaluations paid, the
        # ones an ideally gated scan would pay, and matched slots whose best
        # cell lay inside the strict ellipse
        self.templ_evals_window = 0
        self.templ_evals_gated = 0
        self.matched_in_ellipse = 0
        self.last_gate_stats: dict = {}
        self._window_cells = (2 * search_radius + 1) ** 2
        self._image = None                    # the frame on the device
        self._image_np = None                 # its host copy (template cutting)
        self._prefetched = None               # (image, host copy, corners, valid)
        self._detected = None                 # detection of the current frame
        self.frames_analyzed = 0              # advanced by analyze_frame
        self._n_free_cache = (None, 0)        # (frames_analyzed, free slots)
        # (the recruits tensor last returned, its host copy)
        self._new_pix = (None, np.zeros((self.max_new, 2)))

    def _send(self, *arrays, dtype) -> list[torch.Tensor]:
        """Host arrays to the device as one copy, in numpy ``dtype`` (which
        holds their values exactly), each back in its own shape. On the
        card the copy goes from a pinned buffer without blocking the host:
        a copy from pageable memory would wait for the card."""
        t = torch.from_numpy(np.concatenate(
            [np.asarray(a, dtype).ravel() for a in arrays]))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        out, i = [], 0
        for a in arrays:
            n = int(np.prod(np.shape(a)))
            out.append(t[i:i + n].view(np.shape(a)))
            i += n
        return out

    def _send_matches(self, best: np.ndarray, matched: np.ndarray
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(obs [K,2] float32, zero where unmatched; matched [K]) on the
        device."""
        obs, mask = self._send(np.where(matched[:, None], best, 0.0), matched,
                               dtype=np.float32)
        return obs, mask.to(torch.bool)

    # ---- frames ----
    def _upload(self, image) -> torch.Tensor:
        """The frame as float32 on the device. A host tensor goes as it is
        (a pinned one from io.FrameLoader asynchronously); a numpy frame goes
        through a pinned copy, so the upload never blocks the host."""
        t = image if isinstance(image, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(image))
        if self.device.type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True).to(torch.float32)

    def analyze_frame(self, image_gray=None) -> None:
        """Make ``image_gray`` the current frame; with no argument, take the
        one queued by :meth:`prefetch_frame` (the pipelined loop)."""
        self.frames_analyzed += 1
        if image_gray is None:
            assert self._prefetched is not None, "no prefetched frame"
            self._image, self._image_np, *det = self._prefetched
            self._detected = tuple(det)
            self._prefetched = None
        else:
            self._image_np = _host_f32(image_gray)
            self._image = self._upload(image_gray)
            self._detected = None
            # a later argument-less analyze_frame must not take a frame
            # older than this one
            self._prefetched = None

    def prefetch_frame(self, image_gray) -> None:
        """Upload the next frame and queue its corner detection (which
        needs no state) without touching the current frame. Called right
        after the current frame's filter step is queued, so the upload and
        the Shi-Tomasi pass wait on the card behind that step while the
        host goes on (world/runner.run_image_sequence_pipelined)."""
        img = self._upload(image_gray)
        corners, valid = features.detect_corners(
            img, max_corners=self.detector_max_corners,
            border=self.templ_width)
        self._prefetched = (img, _host_f32(image_gray), corners, valid)

    # ---- CornersMatcherBase.MatchSalientPoints ----
    def match_salient_points(self, state: MonoSlamState, frame_ind: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        K = self.tracker.capacity
        dev = self.device
        if self.suppress_observations or self._image is None:
            # no search ran: no stale telemetry for this frame
            self.last_gate_stats = {}
            return (torch.zeros((K, 2), dtype=torch.float32, device=dev),
                    torch.zeros(K, dtype=torch.bool, device=dev))

        centers, cov2 = self.tracker.predicted_pixel_uncertainty(state)
        sigma_inv = torch.linalg.inv_ex(
            cov2 + 1e-9 * torch.eye(2, dtype=cov2.dtype, device=dev))[0]
        valid, templates = self._send(self.templ_valid, self.templates,
                                      dtype=np.float32)
        active = valid.to(torch.bool) & state.lm_active
        res = self._search(
            self._image, centers.to(torch.float32), templates, active,
            sigma_inv=sigma_inv.to(torch.float32))
        # one read for everything the host needs at this stage
        packed = torch.cat([
            res.matched.to(torch.float64), active.to(torch.float64),
            res.n_gated.to(torch.float64), res.in_ellipse.to(torch.float64),
            res.best_center.to(torch.float64).reshape(-1),
            (~state.lm_active).sum()[None].to(torch.float64)]).cpu().numpy()
        matched, act_np, n_gated_np, in_ell_np = (
            packed[i * K:(i + 1) * K].astype(int if i == 2 else bool)
            for i in range(4))
        best = packed[4 * K:6 * K].reshape(K, 2).astype(np.float32)
        self._n_free_cache = (self.frames_analyzed, int(packed[-1]))
        n_act = int(act_np.sum())
        self.executed_match_templ_calls += n_act
        gated = int(n_gated_np[act_np].sum())
        in_ell = int(in_ell_np[matched].sum())
        window = n_act * self._window_cells
        self.templ_evals_window += window
        self.templ_evals_gated += gated
        self.matched_in_ellipse += in_ell
        self.last_gate_stats = {
            "active": n_act, "window_evals": window, "gated_evals": gated,
            "matched": int(matched.sum()), "matched_in_ellipse": in_ell}
        # template-jump sanity check (reference :723-737): a match far from
        # the previous template center is suspicious
        if self.max_center_jump_pix is not None:
            jump = np.linalg.norm(best - self.last_center, axis=1)
            matched &= ~(self.templ_valid & (jump > self.max_center_jump_pix))
        self.last_center[matched] = best[matched]
        return self._send_matches(best, matched)

    # ---- CornersMatcherBase.RecruitNewSalientPoints ----
    def recruit_new_salient_points(self, state: MonoSlamState, frame_ind: int,
                                   obs_mask) -> tuple[torch.Tensor, torch.Tensor]:
        M = self.max_new
        dev = self.device
        if self.suppress_observations or self._image is None:
            return (torch.zeros((M, 2), dtype=torch.float64, device=dev),
                    torch.zeros(M, dtype=torch.bool, device=dev))
        if self._detected is not None:      # queued by prefetch_frame
            corners, valid = self._detected
        else:
            corners, valid = features.detect_corners(
                self._image, max_corners=self.detector_max_corners,
                border=self.templ_width)
        # no candidate near a tracked landmark's projection
        proj = self.tracker.predicted_pixels(state)
        valid = features.filter_out_closest(
            corners, valid, proj.to(corners.dtype), state.lm_active,
            self.min_dist_new)
        # budget: free slots and the per-frame cap. This frame's match
        # stage read the free count already, unless it did not run
        cached_frame, free = self._n_free_cache
        parts = [corners.to(torch.float64).reshape(-1), valid.to(torch.float64)]
        if cached_frame != self.frames_analyzed:
            parts.append((~state.lm_active).sum()[None].to(torch.float64))
        packed = torch.cat(parts).cpu().numpy()
        N = valid.shape[0]
        corners_np = packed[:2 * N].reshape(N, 2).astype(np.float32)
        valid_np = packed[2 * N:3 * N].astype(bool)
        if cached_frame != self.frames_analyzed:
            free = int(packed[-1])
        cand = corners_np[valid_np][:min(M, free)]
        new_pix = np.zeros((M, 2))
        new_mask = np.zeros(M, bool)
        new_pix[:len(cand)] = cand
        new_mask[:len(cand)] = True
        out, mask = self._send(new_pix, new_mask, dtype=np.float64)
        self._new_pix = (out, new_pix)
        return out, mask.to(torch.bool)

    @property
    def last_new_pix_np(self) -> np.ndarray:
        """Host copy of the latest recruit candidates."""
        return self._new_pix[1]

    def host_new_pix(self, new_pix: torch.Tensor) -> np.ndarray:
        """Host copy of ``new_pix``: the one kept from recruitment if
        ``new_pix`` is the tensor recruitment returned, else a read."""
        kept, host = self._new_pix
        return host if new_pix is kept else new_pix.cpu().numpy()

    # ---- template store ----
    def on_landmarks_added(self, slots: np.ndarray, new_pix: np.ndarray,
                           state: MonoSlamState) -> None:
        """Cut and keep the template patch of each new landmark (reference
        GetBlobTemplate), from the host copy of the frame; ``slots`` and
        ``new_pix`` are host arrays."""
        img = self._image_np
        T = self.templ_width
        half = (T - 1) // 2
        H, W = img.shape
        for s, pix in zip(np.asarray(slots), np.asarray(new_pix)):
            if s < 0:
                continue
            x = int(round(float(pix[0])))
            y = int(round(float(pix[1])))
            x = min(max(x, half), W - half - 1)
            y = min(max(y, half), H - half - 1)
            self.templates[s] = img[y - half: y + half + 1,
                                    x - half: x + half + 1]
            self.templ_valid[s] = True
            self.last_center[s] = (x, y)

    def sync_removed(self, state: MonoSlamState,
                     lm_active_np: np.ndarray | None = None) -> None:
        """Drop the templates of deactivated slots; pass ``lm_active_np``
        when the caller has read the mask already."""
        if lm_active_np is None:
            lm_active_np = state.lm_active.cpu().numpy()
        self.templ_valid &= lm_active_np


class KltCornersMatcher(ImageTemplCornersMatcher):
    """Optical-flow tracking: each landmark's last observed corner is
    tracked from the previous frame to this one with pyramidal Lucas-Kanade
    (vision/klt.py) and gated by the predicted projected-uncertainty
    ellipse (a Mahalanobis chi-square test of the innovation). The
    prototype's pipeline (py_proto/suriko/mvg.py:3331) in the NCC matcher's
    seam; recruitment and the slot bookkeeping are inherited, templates only
    mark occupied slots. It launches no NCC search."""

    def __init__(self, tracker: MonoSlamFilter, *,
                 klt_levels: int = 3, klt_win: int = 7, klt_iters: int = 10,
                 ellipse_confidence: float = 0.95, **kwargs):
        super().__init__(tracker, ellipse_confidence=ellipse_confidence,
                         **kwargs)
        self.klt_levels = klt_levels
        self.klt_win = klt_win
        self.klt_iters = klt_iters
        self._chi2 = float(ell_mod.chi_square_quantile_2dof(ellipse_confidence))
        self._prev_image = None

    def analyze_frame(self, image_gray=None) -> None:
        self._prev_image = self._image
        super().analyze_frame(image_gray)

    def match_salient_points(self, state: MonoSlamState, frame_ind: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        K = self.tracker.capacity
        dev = self.device
        if (self.suppress_observations or self._image is None
                or self._prev_image is None):
            return (torch.zeros((K, 2), dtype=torch.float32, device=dev),
                    torch.zeros(K, dtype=torch.bool, device=dev))

        valid, last_center = self._send(self.templ_valid, self.last_center,
                                        dtype=np.float32)
        active = valid.to(torch.bool) & state.lm_active
        res = klt.track_points(
            self._prev_image, self._image, last_center, active,
            levels=self.klt_levels, win=self.klt_win, iters=self.klt_iters)
        # innovation gate against the predicted projection uncertainty
        centers, cov2 = self.tracker.predicted_pixel_uncertainty(state)
        sigma_inv = torch.linalg.inv_ex(
            cov2 + 1e-9 * torch.eye(2, dtype=cov2.dtype, device=dev))[0]
        innov = res.points - centers.to(res.points.dtype)
        maha = torch.einsum("ki,kij,kj->k", innov,
                            sigma_inv.to(res.points.dtype), innov)
        matched = res.status & active & (maha < self._chi2)
        packed = torch.cat([
            matched.to(torch.float64), res.points.to(torch.float64).reshape(-1),
            active.sum()[None].to(torch.float64),
            (~state.lm_active).sum()[None].to(torch.float64)]).cpu().numpy()
        matched = packed[:K].astype(bool)
        best = packed[K:3 * K].reshape(K, 2).astype(np.float32)
        self._n_free_cache = (self.frames_analyzed, int(packed[-1]))
        self.executed_match_templ_calls += int(packed[-2])
        self.last_center[matched] = best[matched]
        return self._send_matches(best, matched)
