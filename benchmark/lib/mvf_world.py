"""The world of the SfM pass, built on the host in float64 from the seed:
a noisy cylinder of points orbited once by the camera, then a short
revisit of the start that re-detects the first half of the orbit's
landmarks under new track ids; each keyframe's corners with their
detection noise, and the head and revisit keyframes rendered for place
recognition.

A frozen copy of the port's ``demos/mvf_at_scale.World``: its random
draws in its order (points, their appearance, the background, then each
keyframe's noise), so that the same seed gives the same world; every
keyframe is drawn and rendered here, before the pass, and a pass hands the
program a keyframe's corners as its camera input.
"""

from __future__ import annotations

import numpy as np

from benchmark.lib.world import _look_at_cfw
from benchmark.reference.sfm.step import Obs


class MvfWorld:
    """``corners[f]``: (track ids, pixels [n, 2]) of keyframe f as the
    camera reports them; ``head_obs`` and ``tail_obs``: (image, keypoints,
    track ids) of the head and revisit keyframes (the revisit's
    re-detections only); ``obs``: every observation by track
    (``reference.sfm.step.Obs``); ``Rs``, ``ts``, ``points``: the ground
    truth (camera from world)."""

    def __init__(self, cfg: dict, seed: int):
        w, cam = cfg["world"], cfg["camera"]
        self.K = np.asarray(cam["K"], float)
        W, H = cam["image_size"]
        rng = np.random.default_rng(int(seed))
        n_pts, n_base, L = w["points"], w["frames"], w["track_len"]
        self.n_pts, self.n_base = n_pts, n_base
        self.n_total = n_total = n_base + w["revisit_frames"]
        ang = rng.uniform(0, 2 * np.pi, n_pts)
        rad = w["ring_radius"] + rng.normal(scale=w["ring_radius_std"],
                                            size=n_pts)
        z = rng.uniform(0, w["ring_height"], n_pts)
        self.points = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], 1)
        a = 2 * np.pi * (np.arange(n_total) % n_base) / n_base
        h = w["eye_height"]
        eye = np.stack([w["orbit_radius"] * np.cos(a),
                        w["orbit_radius"] * np.sin(a),
                        np.full(n_total, h)], axis=1)
        self.Rs, self.ts = _look_at_cfw(eye, np.broadcast_to([0.0, 0, h],
                                                             eye.shape),
                                        np.array([0.0, 0, 1]))
        facing = (ang / (2 * np.pi) * n_base).astype(int)
        frame_pts = [[] for _ in range(n_total)]
        for i in range(n_pts):
            for k in range(L):
                if facing[i] + k < n_base:
                    frame_pts[facing[i] + k].append(i)
        for f in range(n_base, n_total):
            for i in np.nonzero((f % n_base - facing) % n_base < L)[0]:
                frame_pts[f].append(int(i))
        amps = rng.uniform(*w["splat_amplitude"], n_pts)
        sigmas = rng.uniform(*w["splat_sigma"], n_pts)
        bg = rng.uniform(*w["background"], size=(H, W))
        bg = (bg + np.roll(bg, 1, 0) + np.roll(bg, 1, 1)
              + np.roll(bg, -1, 0) + np.roll(bg, -1, 1)) / 5.0
        n_head = min(12, max(6, w["revisit_frames"]))
        self.corners, self.head_obs, self.tail_obs = [], [], []
        frames, pix = {}, {}
        for f in range(n_total):
            ids = np.asarray(frame_pts[f], int)
            xc = self.points[ids] @ self.Rs[f].T + self.ts[f]
            ok = xc[:, 2] > 0.5
            ph = xc @ self.K.T
            p_true = ph[:, :2] / ph[:, 2:3]
            p = p_true + rng.normal(scale=w["noise_pix"], size=(len(ids), 2))
            head = facing[ids] < n_base // 2
            tid = np.where((f >= n_base) & head, ids + n_pts, ids)[ok]
            p = p[ok]
            self.corners.append((tid, p))
            for k, q in zip(tid.tolist(), p):
                frames.setdefault(k, []).append(f)
                pix.setdefault(k, []).append(q)
            if f < n_head or f >= n_base:
                kept = tid >= n_pts if f >= n_base else np.ones(len(tid), bool)
                if kept.any():
                    img = self._render(bg, amps, sigmas, ids, p_true, ok)
                    (self.tail_obs if f >= n_base else self.head_obs).append(
                        (img, p[kept], tid[kept].tolist()))
        self.obs = Obs({k: np.asarray(v) for k, v in frames.items()},
                       {k: np.asarray(v) for k, v in pix.items()},
                       [c[0].tolist() for c in self.corners])
        self.K_inv = np.linalg.inv(self.K)

    def _render(self, bg, amps, sigmas, ids, pix_true, ok) -> np.ndarray:
        """The keyframe's image: the background and one splat per landmark
        at its true projection, as one [H, K] @ [K, W] product."""
        H, W = bg.shape
        vis = (ok & (pix_true[:, 0] >= 0) & (pix_true[:, 0] < W)
               & (pix_true[:, 1] >= 0) & (pix_true[:, 1] < H))
        s2 = 2.0 * sigmas[ids] ** 2
        ex = np.exp(-(np.arange(W)[None, :] - pix_true[:, 0:1]) ** 2
                    / s2[:, None])
        ey = np.exp(-(np.arange(H)[None, :] - pix_true[:, 1:2]) ** 2
                    / s2[:, None])
        img = bg + (ey * (amps[ids] * vis)[:, None]).T @ ex
        return np.clip(img, 0, 255)

    def write(self, track_store, f: int) -> None:
        """Keyframe ``f``'s corners into the program's track store."""
        tids, pix = self.corners[f]
        for tid, p in zip(tids.tolist(), pix):
            track_store.add_corner(tid, f, p, self.K_inv)
