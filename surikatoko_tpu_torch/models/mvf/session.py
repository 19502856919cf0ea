"""One incremental structure-from-motion pass, a keyframe at a time.

The per-frame pipeline of the at-scale run (reference
MultiViewIterativeFactorizer::IntegrateNewFrameCorners,
multi-view-factorization.cpp:255-397) as a step that a caller drives: it
writes a keyframe's corners into the track store, then calls
:meth:`MvfSession.frame`, which localizes the frame and triangulates its
fresh tracks (with a constant-position fallback when localization fails),
runs the sliding-window BA every ``window_ba_every`` frames and the
bucket-padded global BA every ``global_ba_every`` frames. At the end of the
pass :meth:`MvfSession.close` pairs the revisit's re-detected tracks with
the head's by appearance (``vision/place_recognition``) and closes the
Sim(3) loop through the pose graph; :meth:`MvfSession.global_ba` then
re-polishes the whole map.

    s = MvfSession(track_store, K, base_frames=500, window=25,
                   window_ba_every=5, global_ba_every=25, global_ba_iters=10,
                   point_bucket=2048, frame_bucket=100, pr_ransac_thresh=0.25)
    s.known_frame(cfw, tids, points)       # frames 0 and 1
    for f in range(2, n_frames):
        ...                                # frame f's corners into the store
        s.frame(f)
    closed, pairs, stats = s.close(head_obs, tail_obs)
    s.global_ba()

The poses and the map live on the host (``s.mvf.cam_cfw_R``,
``cam_cfw_t``, ``point_coords``); each step reads its results back before
it returns.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.mvf.factorizer import (
    MultiViewFactorizer, TrackStore)
from surikatoko_tpu_torch.utils.profiling import span
from surikatoko_tpu_torch.vision import place_recognition as pr

# the head frames whose poses the closure's Sim(3) edges tie the revisit to
CLOSURE_HEAD_FRAMES = 6


def _call(_name: str, fn: Callable):
    return fn()


class MvfState(NamedTuple):
    """A pass's state at one moment (:meth:`MvfSession.state`)."""
    cfw_R: list          # [3, 3] camera-from-world rotation of each frame
    cfw_t: list          # [3] its translation
    points: dict         # track id -> [3] map point
    refined: frozenset   # track ids whose point a bundle adjustment refined


class MvfSession:
    """An at-scale incremental SfM pass over ``track_store`` (which the
    caller fills a keyframe at a time) with the shared intrinsics ``K``.
    ``base_frames`` is the length of the sequence before the revisit that
    the closure ties back to its start. ``failures`` counts the frames whose
    localization fell back to the previous pose."""

    def __init__(self, track_store: TrackStore, K: np.ndarray, *,
                 base_frames: int, window: int, window_ba_every: int,
                 global_ba_every: int, global_ba_iters: int,
                 point_bucket: int, frame_bucket: int,
                 pr_ransac_thresh: float,
                 device: torch.device | str = "cuda",
                 dtype: Optional[torch.dtype] = None):
        self.mvf = MultiViewFactorizer(
            track_store=track_store, K=K, use_sparse_ba=True,
            ba_trigger_reproj_err=float("inf"),   # BA on the step's cadence
            ba_term_rel_change=None, ba_max_iters=global_ba_iters,
            ba_point_bucket=point_bucket, ba_frame_bucket=frame_bucket,
            device=device, dtype=dtype)
        self.base_frames = base_frames
        self.window = window
        self.window_ba_every = window_ba_every
        self.global_ba_every = global_ba_every
        self.pr_ransac_thresh = pr_ransac_thresh
        self.failures = 0

    def known_frame(self, cfw: SE3, tids, points) -> None:
        """A bootstrap frame: its pose and its tracks' points as given (the
        reference demo's "well known frames")."""
        self.mvf.add_known_frame(cfw)
        for tid, xyz in zip(tids, points):
            self.mvf.set_known_point(int(tid), xyz)

    def frame(self, f: int, stage: Callable = _call) -> bool:
        """Keyframe ``f`` (its corners already in the track store): integrate
        it, then the BA its index calls for. Each stage runs as
        ``stage(name, fn)`` (``"integrate"``, ``"window_ba"``,
        ``"global_ba"``), which calls ``fn()`` once and returns its result.
        Returns False where localization failed and the previous pose was
        taken instead."""
        mvf = self.mvf
        if f != mvf.frames_count():
            raise ValueError(f"frame {f} arrives after {mvf.frames_count()} "
                             "frames")
        with span("mvf.frame"):
            ok = stage("integrate", mvf.integrate_new_frame_corners)
            if not ok:
                # keep frame and pose indices aligned: constant position
                self.failures += 1
                mvf.add_known_frame(SE3(mvf.cam_cfw_R[-1], mvf.cam_cfw_t[-1]))
            if self.window_ba_every and (f + 1) % self.window_ba_every == 0:
                stage("window_ba",
                      lambda: mvf.run_windowed_ba(window=self.window))
            if self.global_ba_every and (f + 1) % self.global_ba_every == 0:
                stage("global_ba", self.global_ba)
        return bool(ok)

    def state(self) -> MvfState:
        """The poses, the map and which points an adjustment refined, as
        they stand: copies of the containers, sharing their arrays (the
        pipeline replaces a pose or a point, never writes into one)."""
        mvf = self.mvf
        return MvfState(list(mvf.cam_cfw_R), list(mvf.cam_cfw_t),
                        dict(mvf.point_coords), frozenset(mvf._ba_points))

    def global_ba(self) -> None:
        """The global BA over every frame and point (bucket-padded shapes)."""
        self.mvf.run_global_ba()

    def loop_pairs(self, head_obs, tail_obs, sync: Callable | None = None
                   ) -> tuple[list, dict]:
        """The closure's (revisit track, head track) pairs by appearance:
        both groups of (image, keypoints, track ids) described, matched, and
        the candidates verified by the similarity RANSAC on the current map.
        Returns (pairs, stats): the groups' track counts, the candidates and
        each stage's host ms (``sync(device)``, when given, ends each stage,
        so that its ms hold its device work)."""
        mvf = self.mvf
        sync = sync or (lambda _d: None)
        t0 = time.perf_counter()
        head = pr.describe_tracks(head_obs, device=mvf.device)
        tail = pr.describe_tracks(tail_obs, device=mvf.device)
        sync(mvf.device)
        t1 = time.perf_counter()
        cand = pr.match_track_groups(tail, head)
        sync(mvf.device)
        t2 = time.perf_counter()
        pairs = pr.verify_loop_pairs(cand, dict(mvf.point_coords),
                                     self.pr_ransac_thresh,
                                     device=mvf.device, dtype=mvf.dtype)
        sync(mvf.device)
        t3 = time.perf_counter()
        ms = {"describe_ms": 1e3 * (t1 - t0), "match_ms": 1e3 * (t2 - t1),
              "ransac_ms": 1e3 * (t3 - t2)}
        return pairs, {"tracks_revisit": int(tail.tids.size),
                       "tracks_head": int(head.tids.size),
                       "candidates": len(cand), "stage_ms": ms}

    def close(self, head_obs=None, tail_obs=None, *, pairs=None,
              sync: Callable | None = None) -> tuple[bool, list, dict | None]:
        """The loop closure at the end of the pass: the pairs of
        :meth:`loop_pairs` (or ``pairs`` as given, without place
        recognition), then the Sim(3) pose graph that ties the revisit
        frames (``base_frames`` on) to the first frames, and the map
        re-triangulated under the corrected poses. Returns (closed, pairs,
        place recognition's stats or None)."""
        stats = None
        if pairs is None:
            pairs, stats = self.loop_pairs(head_obs, tail_obs, sync)
        closed, _ = self.mvf.close_loop_sim3(
            tail_frames=range(self.base_frames, self.mvf.frames_count()),
            head_frames=range(CLOSURE_HEAD_FRAMES), pairs=pairs, run_ba=False)
        return bool(closed), pairs, stats
