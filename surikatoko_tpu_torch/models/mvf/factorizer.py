"""Incremental multi-view factorizer: the per-frame integration pipeline.

Port of ``surikatoko_tpu/models/mvf/factorizer.py`` (reference
MultiViewIterativeFactorizer::IntegrateNewFrameCorners,
multi-view-factorization.cpp:255-397):
  1. matcher supplies new-frame corners (track continuation + new tracks)
  2. anchor = earlier frame sharing most tracks (FindAnchorFrame :40)
  3. relative motion target<-anchor from the depths of the shared points
  4. triangulate not-yet-reconstructed tracks seen in >=2 frames (MASKS 8.44)
  5. reprojection error; bundle-adjust if above threshold (:378-394)

Track storage is TRACK-MAJOR padded sparse (each track carries up to L
observations: frame index + pixel + normalized coord), never a dense
[tracks x frames] grid: the at-scale configuration (10k+ landmarks, 500+
keyframes) is ~0.2% occupied. The store emits ``BAProblemSparse``
(models/ba/sparse.py) directly; bundle adjustment switches to the banded
sparse Schur solver above a size threshold and stays on the small dense
path below it.

The bookkeeping lives on the host in numpy, as in the JAX package. Each
device call works on bucket-padded shapes (``_bucket``), so a later CUDA
graph sees O(log n) shapes per run. A frame is one upload (every input in
one pinned copy), the fused localize-and-triangulate work, and one packed
read back; a BA is one upload of its problem and one packed read of its
result. ``fake_localization`` / ``fake_mapping`` mirror the reference
demo's GT-substitution debugging aids. ``ba_group`` (the JAX package's
``ba_mesh``) point-shards the sparse BA over a process group
(``parallel.landmark_group``): every rank runs the same factorizer on the
same corners, and only the Schur reduction is split.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom import align
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models import posegraph
from surikatoko_tpu_torch.models.ba import (
    BundleAdjustment, SparseBundleAdjustment, TermCriteria)
from surikatoko_tpu_torch.models.ba import sparse as ba_sparse
from surikatoko_tpu_torch.models.ba.problem import BAProblem
from surikatoko_tpu_torch.models.ba.sparse import BAProblemSparse
from surikatoko_tpu_torch.models.mvf import relative_motion as rm
from surikatoko_tpu_torch.ops.transfer import fetch, host, send
from surikatoko_tpu_torch.utils.profiling import span, spanned


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power of two >= max(n, minimum): bounds the shapes a growing
    map gives the device calls to O(log n)."""
    b = minimum
    while b < n:
        b *= 2
    return b


class TrackStore:
    """Fixed-capacity corner-track repository, track-major padded sparse.

    Like the reference CornerData (multi-view-factorization.h) each corner
    carries both the raw pixel (used by BA/reproj error, pixel K at f0=1)
    and the normalized homogeneous camera coordinate (used by relative
    motion and depth estimation), but stored as padded tracks
    (fidx/pixels/coords of up to ``max_track_len`` observations each)
    instead of the reference CornerTrackRepository's per-frame grid
    (obs-geom.h:267-417), so memory is O(#observations), not
    O(tracks x frames). Host numpy, a copy of the JAX package's."""

    def __init__(self, max_tracks: int, max_frames: int,
                 max_track_len: Optional[int] = None):
        L = int(max_track_len) if max_track_len else int(max_frames)
        self.L = L
        self.max_frames = int(max_frames)
        self.coords = np.zeros((max_tracks, L, 3))   # normalized [x,y,1]
        self.pixels = np.zeros((max_tracks, L, 2))
        self.fidx = np.zeros((max_tracks, L), np.int32)
        self.count = np.zeros(max_tracks, np.int32)
        self.n_tracks = 0
        self._frame_tracks: dict[int, list[int]] = {}

    def add_corner(self, track_id: int, frame_ind: int, pix, K_inv) -> None:
        if track_id >= self.n_tracks:
            self.n_tracks = track_id + 1
        c = int(self.count[track_id])
        if c > 0 and int(self.fidx[track_id, c - 1]) == frame_ind:
            c -= 1                     # overwrite a re-reported corner
        elif c >= self.L:
            return                     # track at capacity: drop (masked world)
        pix = np.asarray(pix, float)[:2]
        h = np.asarray(K_inv) @ np.array([pix[0], pix[1], 1.0])
        self.pixels[track_id, c] = pix
        self.coords[track_id, c] = h / h[2]
        self.fidx[track_id, c] = frame_ind
        if c == int(self.count[track_id]):
            self.count[track_id] = c + 1
            self._frame_tracks.setdefault(int(frame_ind), []).append(
                int(track_id))

    # -- queries ---------------------------------------------------------
    def tracks_in_frame(self, frame_ind: int) -> np.ndarray:
        return np.asarray(self._frame_tracks.get(int(frame_ind), []), int)

    def frames_of(self, track_id: int) -> np.ndarray:
        return self.fidx[track_id, : self.count[track_id]]

    def slot_of(self, track_id: int, frame_ind: int) -> int:
        row = self.frames_of(track_id)
        hit = np.nonzero(row == frame_ind)[0]
        return int(hit[0]) if len(hit) else -1

    def has(self, track_id: int, frame_ind: int) -> bool:
        return self.slot_of(track_id, frame_ind) >= 0

    def coord(self, track_id: int, frame_ind: int) -> np.ndarray:
        return self.coords[track_id, self.slot_of(track_id, frame_ind)]

    def n_obs(self) -> int:
        return int(self.count[: self.n_tracks].sum())

    def sparse_observations(self, tids, n_frames: int,
                            track_len: Optional[int] = None):
        """(obs [Np,L,2], frame_idx [Np,L], obs_mask [Np,L]) for the given
        track ids, restricted to frames < n_frames: the BAProblemSparse
        observation triple, emitted straight from the padded store."""
        tids = np.asarray(tids, int)
        cnt = self.count[tids]
        L = int(track_len) if track_len else max(int(cnt.max(initial=1)), 1)
        obs = self.pixels[tids, :L].copy()
        fidx = self.fidx[tids, :L].copy()
        mask = np.arange(L)[None, :] < cnt[:, None]
        mask &= fidx < n_frames
        fidx = np.where(mask, fidx, 0)
        obs[~mask] = 0.0
        return obs, fidx.astype(np.int32), mask


def _nearest_rotations(R: np.ndarray) -> np.ndarray:
    """The nearest rotations (polar factors U V^T with det +1) of a batch of
    3x3 matrices."""
    U, _, Vt = np.linalg.svd(R)
    U[..., :, 2] *= np.sign(np.linalg.det(U @ Vt))[..., None]
    return U @ Vt


# ---- device work of a frame --------------------------------------------

def _localize_core(c1, c2, depths, mask, pts, R_init, t_init, R_prev, t_prev,
                   refine: bool):
    """SVD-12 relative motion composed with the anchor pose, then
    (optionally) GN-PnP polish seeded from the better of {SVD estimate,
    previous frame pose}: both polishes run as one batch of two. Returns
    (R_new, t_new, ok)."""
    rel, ok = rm.find_relative_motion_multi_points(c1, c2, depths, mask)
    R_new = rel.R @ R_init
    t_new = rel.R @ t_init + rel.t
    if refine:
        R2, t2, rms = rm.refine_pose_pnp(
            pts.expand(2, -1, -1), c2.expand(2, -1, -1),
            mask.expand(2, -1), torch.stack([R_new, R_prev]),
            torch.stack([t_new, t_prev]))
        take_a = rms[0] <= rms[1]
        R_new = torch.where(take_a, R2[0], R2[1])
        t_new = torch.where(take_a, t2[0], t2[1])
    return R_new, t_new, ok


def _pack_pose(R_new, t_new, ok):
    """[13] = [R.ravel(9), t(3), ok(1)]: the three values the host reads
    every frame, in one copy."""
    return torch.cat([R_new.reshape(-1), t_new, ok.to(R_new.dtype)[None]])


def _triangulate_core(x_base, xs, R_fb, T_fb, msk,
                      obs_w, R_w, t_w, msk_w, Rb, tb, refine: bool):
    """Linear MASKS-8.44 depth + world lift + optional GN polish, batched
    over the tracks. Returns one packed [N,5] array [x_world(3), depth(-1 =
    behind), parallax_ratio]."""
    depth = rm.estimate_point_depth(x_base, xs, R_fb, T_fb, msk)
    d_ok = torch.isfinite(depth) & (depth > 0)
    d_safe = torch.where(d_ok, depth, 1.0)
    x_lin = torch.einsum("nji,nj->ni", Rb, x_base * d_safe[:, None] - tb)
    mw = msk_w.to(x_base.dtype)

    def rms(X):
        xc = torch.einsum("nmij,nj->nmi", R_w, X) + t_w
        z = xc[..., 2:3]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        r = (xc[..., :2] / zs - obs_w[..., :2]) * mw[..., None]
        n = torch.clamp(torch.sum(mw, dim=1), min=1)
        return torch.sqrt(torch.sum(r * r, dim=(1, 2)) / n)

    # parallax proxy: camera-center spread of the observing frames over the
    # point's depth. Near-zero-parallax triangulations are depth-noise
    # amplifiers; feeding them to localization drives systematic scale
    # drift (measured ~0.09 per frame on the 500-frame orbit).
    centers = -torch.einsum("nmji,nmj->nmi", R_w, t_w)     # [N,M,3]
    m3 = mw[..., None]
    cmean = (torch.sum(centers * m3, dim=1)
             / torch.clamp(torch.sum(m3, dim=1), min=1))
    spread = torch.sqrt(torch.amax(
        torch.sum((centers - cmean[:, None, :]) ** 2, -1) * mw, dim=1))
    parallax_ratio = 2.0 * spread / torch.clamp(d_safe, min=1e-9)

    if refine:
        x_ref = rm.refine_point_gn(x_lin, obs_w, R_w, t_w, msk_w)
        # accept the polish only when it actually reduces the reprojection
        # rms AND keeps the point in front of the base camera: a GN step on
        # a near-parallel ray pair can shoot the point to ~infinity (seen
        # at the 500-frame orbit: depths ~1e10 poisoned the map)
        z_ref = (torch.einsum("nij,nj->ni", Rb, x_ref) + tb)[:, 2]
        good = (torch.isfinite(x_ref).all(dim=1)
                & (rms(x_ref) <= rms(x_lin)) & (z_ref > 1e-6))
        x_lin = torch.where(good[:, None], x_ref, x_lin)
    return torch.cat([x_lin, torch.where(d_ok, depth, -1.0)[:, None],
                      parallax_ratio[:, None]], dim=1)


def _integrate(c1, c2, depths, mask, pts, R_init, t_init, R_prev, t_prev,
               x_base, xs, R_fb, T_fb, msk_fb, new_fb,
               obs_w, R_w, t_w, msk_w, new_w, Rb, tb,
               refine_loc: bool, refine_map: bool):
    """Localize the new frame AND triangulate its fresh tracks in one go,
    with nothing read back in between. The triangulation batch is assembled
    host-side BEFORE the new pose exists; entries observed at the new frame
    carry placeholders flagged by ``new_fb`` / ``new_w`` and the
    just-computed pose substitutes in here. Returns (pose13, packed [N,5])."""
    R_new, t_new, ok = _localize_core(c1, c2, depths, mask, pts,
                                      R_init, t_init, R_prev, t_prev,
                                      refine_loc)
    # frame-from-base blocks for new-frame observations: R_new @ Rb^T
    sub_R = torch.einsum("ij,nkj->nik", R_new, Rb)            # [N,3,3]
    sub_T = t_new[None, :] - torch.einsum("nik,nk->ni", sub_R, tb)
    R_fb2 = torch.where(new_fb[..., None, None], sub_R[:, None], R_fb)
    T_fb2 = torch.where(new_fb[..., None], sub_T[:, None], T_fb)
    R_w2 = torch.where(new_w[..., None, None], R_new, R_w)
    t_w2 = torch.where(new_w[..., None], t_new, t_w)
    packed = _triangulate_core(x_base, xs, R_fb2, T_fb2, msk_fb,
                               obs_w, R_w2, t_w2, msk_w, Rb, tb, refine_map)
    return _pack_pose(R_new, t_new, ok), packed


@dataclass
class MultiViewFactorizer:
    track_store: TrackStore
    K: np.ndarray                       # shared 3x3 intrinsics (f0=1 units)
    ba_trigger_reproj_err: float = 1e-3
    ba_term_rel_change: Optional[float] = 1e-3
    ba_max_iters: int = 300
    refine_localization: bool = True   # GN-PnP polish of the SVD-12 estimate
    refine_mapping: bool = True        # GN point polish of the linear depth
    # reconstruct a track only once its observing-camera spread exceeds this
    # fraction of the depth (~2% = 1.1 deg parallax): near-parallel-ray
    # triangulations amplify pixel noise into depth and, fed to the
    # localizer, drive systematic scale drift
    min_parallax_ratio: float = 0.02
    fake_localization: bool = False
    fake_mapping: bool = False
    gt_cfw_fun: Optional[Callable[[int], SE3]] = None
    gt_point_fun: Optional[Callable[[int], np.ndarray]] = None
    # BA backend: None = auto by size (dense grid cells above the threshold
    # switch to the banded sparse Schur path)
    use_sparse_ba: Optional[bool] = None
    sparse_ba_threshold: int = 200_000   # Np * F dense-grid cells
    ba_point_chunk: int = 2048
    # process group for a point-sharded sparse BA (host LM loop, so
    # ba_device_loop False), or None
    ba_group: object = None
    # shape buckets for periodic global BA on a growing problem: points
    # padded to a multiple of ba_point_bucket (with ba_group, a multiple of
    # its size), frames padded (and pinned) to multiples of ba_frame_bucket
    ba_point_bucket: int = 0             # 0 = a multiple of 8 x the ranks
    ba_frame_bucket: int = 0             # 0 = exact frame count
    # each BA's LM through models/ba/lm_device: one packed read per trial
    # instead of the host loop's two
    ba_device_loop: bool = True
    # where the device work runs (the card unless the caller says
    # otherwise) and in which type (default config.default_dtype(device))
    device: torch.device | str = "cuda"
    dtype: Optional[torch.dtype] = None
    # state
    cam_cfw_R: list = field(default_factory=list)
    cam_cfw_t: list = field(default_factory=list)
    point_coords: dict = field(default_factory=dict)   # track_id -> xyz
    ba_runs: int = field(default=0)
    last_ba_sparse: bool = field(default=False)
    last_closure_inliers: int = field(default=0)
    # (s, R, t) with head ~ s R tail + t: the similarity the last Sim(3)
    # closure measured, or None
    last_closure_similarity: tuple = field(default=None)
    # (kind, ok, stop_reason, iterations, trials) of every BA run, in order
    ba_log: list = field(default_factory=list)
    _ba_points: set = field(default_factory=set)   # tids refined by BA
    _window_ba: object = field(default=None)
    _window_ba_key: tuple = field(default=None)
    _ba_cache: dict = field(default_factory=dict)
    # per-stage wall-clock accumulators (window_ba / global_ba
    # build/compute/readback phases; see run_windowed_ba): the reference's
    # per-frame duration slices (DavisonMonoSlamInternalsLogger), applied
    # to the SfM pipeline
    profile: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.dtype = self.dtype or config.default_dtype(self.device)
        if self.ba_group is not None:
            if self.ba_device_loop:
                raise ValueError("the point-sharded BA runs in the host loop: "
                                 "ba_device_loop must be False with ba_group")
            n = dist.get_world_size(self.ba_group)
            if self.ba_point_bucket % n:
                raise ValueError(f"ba_point_bucket {self.ba_point_bucket} "
                                 f"does not divide by the group's {n} ranks")

    def frames_count(self) -> int:
        return len(self.cam_cfw_R)

    def _send(self, *arrays) -> list[torch.Tensor]:
        return send(self.device, self.dtype, *arrays)

    # ---- bootstrap (the demo's "well_known_frames": first 2 frames carry GT
    # pose and GT points, demo-multi-view-factorization.cpp:528-600) ----
    def add_known_frame(self, cfw: SE3) -> None:
        self.cam_cfw_R.append(host(cfw.R))
        self.cam_cfw_t.append(host(cfw.t))

    def set_known_point(self, track_id: int, xyz) -> None:
        self.point_coords[int(track_id)] = np.asarray(host(xyz), float)
        # known points are authoritative: never re-triangulated over
        self._ba_points.add(int(track_id))

    # ---- reference FindAnchorFrame :40 ----
    def find_anchor_frame(self, new_frame: int) -> tuple[int, np.ndarray]:
        ts = self.track_store
        cur = [t for t in ts.tracks_in_frame(new_frame)
               if int(t) in self.point_coords]
        counts = np.zeros(max(new_frame, 1), np.int64)
        for tid in cur:
            fr = ts.frames_of(int(tid))
            fr = fr[fr < new_frame]
            counts[fr] += 1
        anchor = int(np.argmax(counts)) if new_frame > 0 else 0
        common = np.asarray(
            [t for t in cur if ts.has(int(t), anchor)], int)
        return anchor, common

    @spanned("mvf.integrate")
    def integrate_new_frame_corners(self) -> bool:
        """Assumes the matcher already wrote this frame's corners into the
        track store. Returns False if the frame couldn't be integrated."""
        new_frame = self.frames_count()
        if new_frame < 2:
            raise RuntimeError(
                "bootstrap the first two frames with add_known_frame() first")
        with span("mvf.localize"):
            loc_host = self._localization_inputs(new_frame)
        if loc_host is None:
            return False
        refine_loc = self.refine_localization and not self.fake_localization
        with span("mvf.triangulate"):
            cands = self._tri_candidates(self._fresh_tracks(new_frame),
                                         new_frame)
            fused = bool(cands) and not self.fake_localization
            if fused:
                batch = self._assemble_tri_batch(cands, mark_frame=new_frame)
        tri = {}
        if fused:
            # fused path: localize + triangulate the fresh tracks with ONE
            # upload and ONE packed read
            args = self._send(*loc_host, *batch)
            args[3] = args[3] > 0.5                       # mask
            for k in (13, 14, 18, 19):                    # msk_fb, new_fb,
                args[k] = args[k] > 0.5                   # msk_w, new_w
            pose_np, tri_np = fetch(*_integrate(
                *args, refine_loc=refine_loc,
                refine_map=self.refine_mapping))
            R_new, t_new, ok = (pose_np[:9].reshape(3, 3), pose_np[9:12],
                                pose_np[12])
            if ok <= 0.5:
                return False
            with span("mvf.triangulate"):
                tri = self._accept_triangulations(cands, tri_np)
        else:
            args = self._send(*loc_host)
            args[3] = args[3] > 0.5
            (pose_np,) = fetch(_pack_pose(*_localize_core(
                *args, refine=refine_loc)))
            R_new, t_new, ok = (pose_np[:9].reshape(3, 3), pose_np[9:12],
                                pose_np[12])
            if ok <= 0.5:
                return False

        if self.fake_localization and self.gt_cfw_fun is not None:
            gt = self.gt_cfw_fun(new_frame)
            self.cam_cfw_R.append(host(gt.R))
            self.cam_cfw_t.append(host(gt.t))
        else:
            self.cam_cfw_R.append(R_new)
            self.cam_cfw_t.append(t_new)

        with span("mvf.triangulate"):
            if fused:
                self._store_triangulations(tri)
            else:
                # fake-localization path triangulates under the (GT)
                # appended pose; empty-candidate frames are a no-op either
                # way
                self._reconstruct_new_tracks(new_frame)

        # BA trigger (no read at all when the trigger is disabled)
        if self.ba_trigger_reproj_err != float("inf"):
            err = self._reproj_error()
            if err > self.ba_trigger_reproj_err:
                self.run_global_ba()
        return True

    def _localization_inputs(self, new_frame: int) -> tuple | None:
        """The host arrays of the frame's localization (bucket-padded
        anchor and new-frame coordinates of the tracks the two share, their
        depths in the anchor, the mask, their points, the anchor's and the
        previous frame's poses), or None where nothing can localize it."""
        ts = self.track_store
        anchor, common = self.find_anchor_frame(new_frame)
        if len(common) == 0:
            return None

        # depths of common (already reconstructed) points in the anchor frame
        Ra, ta = self.cam_cfw_R[anchor], self.cam_cfw_t[anchor]
        pts = np.stack([self.point_coords[int(t)] for t in common])
        depths = (pts @ Ra.T + ta)[:, 2]
        # a drifted point can sit behind the anchor camera: 1/depth feeds
        # the SVD-12 system, and inf * mask-zero = NaN would sink the whole
        # SVD: sanitize the value AND mask the row (masked-slot NaN rule)
        good_d = np.isfinite(depths) & (depths > 1e-6)
        if not good_d.any():
            return None

        n = len(common)
        nb = _bucket(n)
        c1 = np.zeros((nb, 3))
        c2 = np.zeros((nb, 3))
        dep = np.ones(nb)
        ptsb = np.zeros((nb, 3))
        msk = np.zeros(nb, bool)
        for i, t in enumerate(common):
            c1[i] = ts.coord(int(t), anchor)
            c2[i] = ts.coord(int(t), new_frame)
        dep[:n] = np.where(good_d, depths, 1.0)
        ptsb[:n] = pts
        msk[:n] = good_d
        return (c1, c2, dep, msk, ptsb, Ra, ta,
                self.cam_cfw_R[-1], self.cam_cfw_t[-1])

    # ---- triangulation (MASKS 8.44), batched over candidate tracks ----
    def _tri_candidates(self, tids, upto_frame: int) -> list:
        ts = self.track_store
        cands = []
        for tid in tids:
            fr = ts.frames_of(int(tid))
            sel = np.nonzero(fr <= upto_frame)[0]
            if len(sel) >= 2:
                cands.append((int(tid), sel))
        return cands

    def _assemble_tri_batch(self, cands, mark_frame: int | None = None):
        """Bucketed triangulation batch arrays (host numpy) for ``cands``.
        With ``mark_frame`` set, observations at that frame get identity/zero
        POSE placeholders plus True entries in the returned (new_fb, new_w)
        masks: the fused integrate step substitutes the just-computed pose
        there (the pose list does not contain it yet)."""
        ts = self.track_store
        n_have = len(self.cam_cfw_R)
        R_all = np.stack(self.cam_cfw_R)
        t_all = np.stack(self.cam_cfw_t)
        M = max(len(sel) for _, sel in cands) - 1
        Nb, Mb = _bucket(len(cands)), _bucket(M, minimum=4)
        x_base = np.zeros((Nb, 3))
        xs = np.zeros((Nb, Mb, 3))
        R_fb = np.broadcast_to(np.eye(3), (Nb, Mb, 3, 3)).copy()
        T_fb = np.zeros((Nb, Mb, 3))
        msk = np.zeros((Nb, Mb), bool)
        new_fb = np.zeros((Nb, Mb), bool)
        obs_w = np.zeros((Nb, Mb + 1, 3))
        R_w = np.broadcast_to(np.eye(3), (Nb, Mb + 1, 3, 3)).copy()
        t_w = np.zeros((Nb, Mb + 1, 3))
        msk_w = np.zeros((Nb, Mb + 1), bool)
        new_w = np.zeros((Nb, Mb + 1), bool)
        Rb_all = np.broadcast_to(np.eye(3), (Nb, 3, 3)).copy()
        tb_all = np.zeros((Nb, 3))
        for i, (tid, sel) in enumerate(cands):
            fr = ts.frames_of(tid)[sel]
            base = int(fr[0])          # a track's FIRST obs is never at
            Rb, tb = R_all[base], t_all[base]   # mark_frame (needs >=2 obs)
            others = fr[1:]
            is_new_o = others >= n_have
            safe_o = np.where(is_new_o, 0, others)
            k = len(others)
            x_base[i] = ts.coords[tid, sel[0]]
            xs[i, :k] = ts.coords[tid, sel[1:]]
            R_fb[i, :k] = R_all[safe_o] @ Rb.T
            T_fb[i, :k] = t_all[safe_o] - np.einsum(
                "fij,j->fi", R_fb[i, :k], tb)
            msk[i, :k] = True
            new_fb[i, :k] = is_new_o
            kf = len(fr)
            is_new_f = fr >= n_have
            safe_f = np.where(is_new_f, 0, fr)
            obs_w[i, :kf] = ts.coords[tid, sel]
            R_w[i, :kf] = R_all[safe_f]
            t_w[i, :kf] = t_all[safe_f]
            msk_w[i, :kf] = True
            new_w[i, :kf] = is_new_f
            Rb_all[i] = Rb
            tb_all[i] = tb
        return (x_base, xs, R_fb, T_fb, msk, new_fb, obs_w, R_w, t_w,
                msk_w, new_w, Rb_all, tb_all)

    def _accept_triangulations(self, cands, packed: np.ndarray) -> dict:
        """{tid: xyz} from the packed [N,5] triangulation result (finite,
        in-front, enough parallax)."""
        x_out, depth, par = packed[:, :3], packed[:, 3], packed[:, 4]
        out = {}
        for i, (tid, sel) in enumerate(cands):
            if (depth[i] > 0 and np.isfinite(x_out[i]).all()
                    and par[i] >= self.min_parallax_ratio):
                out[tid] = x_out[i]
        return out

    def _store_triangulations(self, tri: dict) -> None:
        for tid, x_world in tri.items():
            if self.fake_mapping and self.gt_point_fun is not None:
                x_world = np.asarray(host(self.gt_point_fun(int(tid))))
            self.point_coords[int(tid)] = x_world

    def _triangulate_tracks(self, tids, upto_frame: int) -> dict:
        """Batched depth of each track from all its observations up to (and
        including) `upto_frame`, under the current camera poses: one upload
        and one read per call. Returns {tid: xyz_world} for the tracks whose
        depth came out finite and positive."""
        cands = self._tri_candidates(tids, upto_frame)
        if not cands:
            return {}
        (x_base, xs, R_fb, T_fb, msk, _new_fb, obs_w, R_w, t_w, msk_w,
         _new_w, Rb_all, tb_all) = self._assemble_tri_batch(cands)
        a = self._send(x_base, xs, R_fb, T_fb, msk, obs_w, R_w, t_w, msk_w,
                       Rb_all, tb_all)
        a[4], a[8] = a[4] > 0.5, a[8] > 0.5
        (packed,) = fetch(_triangulate_core(*a, refine=self.refine_mapping))
        return self._accept_triangulations(cands, packed)

    def _fresh_tracks(self, new_frame: int) -> list:
        ts = self.track_store
        # new tracks, plus re-triangulation of linear-only tracks (not yet
        # through BA): their first depth came from a tiny baseline; as the
        # track accrues frames the linear estimate sharpens, and overriding
        # it is safe until BA has produced something better
        return [int(t) for t in ts.tracks_in_frame(new_frame)
                if int(t) not in self.point_coords
                or int(t) not in self._ba_points]

    def _reconstruct_new_tracks(self, new_frame: int) -> None:
        tri = self._triangulate_tracks(self._fresh_tracks(new_frame),
                                       new_frame)
        self._store_triangulations(tri)

    # ---- BA problem emission -------------------------------------------
    def _bucketed_track_len(self, tids) -> int:
        """Observation-array width for a BA problem over ``tids``: the max
        track count rounded up to a multiple of 8, capped at the store
        width: a handful of stable shapes instead of one per track-growth
        step."""
        ts = self.track_store
        lmax = int(ts.count[np.asarray(tids, int)].max(initial=1))
        return min(ts.pixels.shape[1], -(-max(lmax, 1) // 8) * 8)

    def _sparse_from_host(self, pts, cfw_R, cfw_t, obs, fidx, mask
                          ) -> BAProblemSparse:
        """BAProblemSparse on the device from host arrays, in one upload
        (K shared by every frame)."""
        a = self._send(pts, cfw_R, cfw_t, np.asarray(self.K, float), obs,
                       fidx, mask, 1.0)
        n_f = cfw_R.shape[0]
        return BAProblemSparse(
            points=a[0], cfw_R=a[1], cfw_t=a[2],
            K=a[3].expand(n_f, 3, 3).contiguous(), obs=a[4],
            frame_idx=a[5].to(torch.int64), obs_mask=a[6] > 0.5, f0=a[7])

    def _sparse_problem(self, pad_points: int = 1,
                        track_len: Optional[int] = None,
                        pad_frames: int = 0
                        ) -> tuple[list, BAProblemSparse]:
        """Emit BAProblemSparse straight from the track store: no dense
        [Np, F] grid anywhere. `pad_points` rounds Np up (masked rows) so
        the shapes stay stable; `pad_frames` rounds the frame count up with
        identity cameras (the caller must PIN the pad frames: they carry no
        observations, so their normal-equation blocks are singular without
        the pin's unit diagonal)."""
        tids = sorted(self.point_coords)
        ts = self.track_store
        n_f = self.frames_count()
        n_fp = n_f if not pad_frames else -(-n_f // pad_frames) * pad_frames
        if track_len is None:
            # bucketed L so the global BA's shapes survive incremental
            # track growth (see run_windowed_ba)
            track_len = self._bucketed_track_len(tids)
        obs, fidx, mask = ts.sparse_observations(tids, n_f, track_len)
        Np = len(tids)
        pad = (-Np) % pad_points
        if pad:
            obs = np.concatenate([obs, np.zeros((pad,) + obs.shape[1:])])
            fidx = np.concatenate(
                [fidx, np.zeros((pad,) + fidx.shape[1:], np.int32)])
            mask = np.concatenate(
                [mask, np.zeros((pad,) + mask.shape[1:], bool)])
        pts = np.stack([self.point_coords[t] for t in tids])
        if pad:
            pts = np.concatenate([pts, np.zeros((pad, 3))])
        # host-side observation structure for the BA's banding plan (the
        # plan is numpy; see SparseBundleAdjustment.set_plan_inputs)
        self._last_sparse_inputs = (fidx, mask)
        cfw_R = np.stack(self.cam_cfw_R)
        cfw_t = np.stack(self.cam_cfw_t)
        if n_fp > n_f:
            cfw_R = np.concatenate(
                [cfw_R, np.broadcast_to(np.eye(3), (n_fp - n_f, 3, 3))])
            cfw_t = np.concatenate([cfw_t, np.zeros((n_fp - n_f, 3))])
        return tids, self._sparse_from_host(pts, cfw_R, cfw_t, obs, fidx,
                                            mask)

    def _dense_problem(self):
        """Small-problem path: materialize the dense grid from the sparse
        store (only below sparse_ba_threshold)."""
        tids = sorted(self.point_coords)
        ts = self.track_store
        n_f = self.frames_count()
        obs_s, fidx, mask_s = ts.sparse_observations(tids, n_f)
        Np, L = mask_s.shape
        obs = np.zeros((Np, n_f, 2))
        mask = np.zeros((Np, n_f), bool)
        rows = np.repeat(np.arange(Np), L).reshape(Np, L)
        sel = mask_s
        mask[rows[sel], fidx[sel]] = True
        obs[rows[sel], fidx[sel]] = obs_s[sel]
        pts = np.stack([self.point_coords[t] for t in tids])
        a = self._send(pts, np.stack(self.cam_cfw_R),
                       np.stack(self.cam_cfw_t), np.asarray(self.K, float),
                       obs, mask, 1.0)
        return tids, BAProblem(
            points=a[0], cfw_R=a[1], cfw_t=a[2],
            K=a[3].expand(n_f, 3, 3).contiguous(), obs=a[4],
            obs_mask=a[5] > 0.5, f0=a[6])

    def _reproj_error(self) -> float:
        if len(self.point_coords) == 0 or self.frames_count() < 2:
            return 0.0
        nb = _bucket(len(self.point_coords), minimum=16)
        _, p = self._sparse_problem(pad_points=nb)
        return float(ba_sparse.reproj_error(p))

    # ---- pose-graph loop closure (north-star addition; the reference's MVF
    # only chains odometry and re-runs BA, multi-view-factorization.cpp:255) --
    def measure_relative_pose(self, i: int, j: int, min_common: int = 6
                              ) -> tuple[Optional[SE3], int]:
        """Independent measurement of the camera-j-from-camera-i transform
        from tracks seen in both frames (depths from the reconstructed map in
        frame i): the same SVD-12 solver used for odometry, applied to a
        non-adjacent candidate loop pair. Returns (rel, #common) with rel
        None when support is too thin; rel holds host arrays (R, t and ok
        come back in one read)."""
        ts = self.track_store
        in_j = set(int(t) for t in ts.tracks_in_frame(j))
        common = [int(t) for t in ts.tracks_in_frame(i)
                  if int(t) in in_j and int(t) in self.point_coords]
        if len(common) < min_common:
            return None, len(common)
        Ri, ti = self.cam_cfw_R[i], self.cam_cfw_t[i]
        pts = np.stack([self.point_coords[t] for t in common])
        depths = (pts @ Ri.T + ti)[:, 2]
        ci = np.stack([ts.coord(t, i) for t in common])
        cj = np.stack([ts.coord(t, j) for t in common])
        a = self._send(ci, cj, depths)
        rel, ok = rm.find_relative_motion_multi_points(
            *a, torch.ones(len(common), dtype=torch.bool, device=self.device))
        (pose,) = fetch(_pack_pose(rel.R, rel.t, ok))
        if pose[12] <= 0.5:
            return None, len(common)
        return SE3(pose[:9].reshape(3, 3), pose[9:12]), len(common)

    def _world_from_cameras(self):
        """(R_w [N,3,3], t_w [N,3]) world-from-camera poses (host)."""
        R_w = np.stack([R.T for R in self.cam_cfw_R])
        t_w = np.stack([-R.T @ t
                        for R, t in zip(self.cam_cfw_R, self.cam_cfw_t)])
        return R_w, t_w

    def _set_from_world(self, g) -> None:
        """Camera poses from an optimized graph's world-from-camera nodes
        (one packed read)."""
        R_w, t_w = fetch(g.R, g.t)
        for f in range(self.frames_count()):
            self.cam_cfw_R[f] = R_w[f].T
            self.cam_cfw_t[f] = -R_w[f].T @ t_w[f]

    def apply_pose_graph(self, loop_closures, *, odometry_weight: float = 1.0,
                         iters: int = 20, run_ba: bool = False) -> None:
        """Correct accumulated drift with SE(3) pose-graph optimization
        (models/posegraph.py): odometry edges from the current consecutive
        relative poses, plus `loop_closures` = [(i, j, rel_cj_from_ci: SE3,
        weight)]. The map is re-triangulated from the corrected poses: that
        is the least-squares structure-only refit, so the correction sticks.

        `run_ba=True` re-runs bundle adjustment afterwards with the closure
        frames PINNED (fixed-keyframe BA). Reprojection error alone is blind
        to a pose-graph-only closure (unconstrained BA would relax the poses
        back toward the drifted odometry optimum), so the frames that carry
        closure information are frozen while the rest re-polish against the
        observations."""
        n = self.frames_count()
        R_w, t_w = self._world_from_cameras()
        edges = []
        for k in range(n - 1):
            rel_R = R_w[k].T @ R_w[k + 1]
            rel_t = R_w[k].T @ (t_w[k + 1] - t_w[k])
            edges.append((k, k + 1, rel_R, rel_t, odometry_weight))
        for (i, j, rel, w) in loop_closures:
            # rel maps cam-i coords to cam-j coords; T_i^-1 T_j = rel^-1
            Zr = host(rel.R).T
            edges.append((i, j, Zr, -Zr @ host(rel.t), w))

        g = posegraph.make_pose_graph(R_w, t_w, edges, device=self.device,
                                      dtype=self.dtype)
        self._set_from_world(posegraph.optimize_pose_graph(g, iters=iters))

        # re-triangulate the whole map under the corrected poses (batched)
        tri = self._triangulate_tracks(list(self.point_coords), n - 1)
        self.point_coords.update(tri)

        if run_ba:
            pins = sorted({int(i) for (i, j, _, _) in loop_closures}
                          | {int(j) for (i, j, _, _) in loop_closures})
            self.run_global_ba(pin_frames=tuple(pins))

    def _profile(self, name: str) -> dict:
        return self.profile.setdefault(
            name, {"build": 0.0, "compute": 0.0, "readback": 0.0,
                   "runs": 0, "per_run": []})

    def _log_ba(self, kind: str, ok: bool, ba) -> None:
        self.ba_log.append((kind, bool(ok), ba.stop_reason,
                            int(ba.iterations), int(ba.trials)))

    @spanned("ba.window")
    def run_windowed_ba(self, window: int = 25,
                        point_bucket: int = 512) -> bool:
        """Sliding-window local BA: optimize the last `window` camera poses
        and the points they observe, with the two OLDEST window frames
        pinned as the gauge anchor (fixed-keyframe BA, no normalization
        needed). Shapes are static (window fixed, points bucket-padded), so
        the whole run sees a handful of shapes as the map grows. A full
        `run_global_ba` at the end still polishes globally. New capability
        beyond the reference (its MVF re-runs global BA on every trigger,
        multi-view-factorization.cpp:378-394, which cannot scale)."""
        prof = self._profile("window_ba")
        _t0 = time.perf_counter()
        F = self.frames_count()
        if F < window:
            return False
        base = F - window
        ts = self.track_store
        with span("ba.build"):
            # tracks observed in the window AND reconstructed
            tids = sorted({int(t) for f in range(base, F)
                           for t in ts.tracks_in_frame(f)}
                          & set(self.point_coords))
            if not tids:
                return False
            # track_len bucketed to multiples of 8 (capped at the store
            # width); truncating instead would drop the NEWEST observations,
            # exactly the in-window ones
            obs, fidx, mask = ts.sparse_observations(
                tids, F, track_len=self._bucketed_track_len(tids))
            # restrict to window frames, local indexing
            inwin = mask & (fidx >= base)
            fidx_l = np.where(inwin, fidx - base, 0).astype(np.int32)
            obs = np.where(inwin[..., None], obs, 0.0)
            Np = len(tids)
            Npad = _bucket(Np, minimum=point_bucket)
            pad = Npad - Np
            pts = np.stack([self.point_coords[t] for t in tids])
            if pad:
                pts = np.concatenate([pts, np.zeros((pad, 3))])
                obs = np.concatenate([obs, np.zeros((pad,) + obs.shape[1:])])
                fidx_l = np.concatenate(
                    [fidx_l, np.zeros((pad,) + fidx_l.shape[1:], np.int32)])
                inwin = np.concatenate(
                    [inwin, np.zeros((pad,) + inwin.shape[1:], bool)])
            p = self._sparse_from_host(
                pts, np.stack(self.cam_cfw_R[base:]),
                np.stack(self.cam_cfw_t[base:]), obs, fidx_l, inwin)
        if self._window_ba is None or self._window_ba_key != (window,):
            self._window_ba = SparseBundleAdjustment(
                optimize_intrinsics=False, pin_frames=(0, 1),
                point_chunk=min(self.ba_point_chunk, point_bucket),
                band=False, device_loop=self.ba_device_loop)
            self._window_ba_key = (window,)
        ba = self._window_ba
        term = TermCriteria(
            allowed_reproj_err_rel_change=self.ba_term_rel_change,
            max_iters=self.ba_max_iters)
        _t1 = time.perf_counter()
        ok, p_opt = ba.compute(p, term)    # gauge = the two pinned frames
        _t2 = time.perf_counter()
        self.ba_runs += 1
        self.last_ba_sparse = True
        self._log_ba("window", ok, ba)
        if not ok:
            return False
        pts_o, R_o, t_o = fetch(p_opt.points, p_opt.cfw_R, p_opt.cfw_t)
        _t3 = time.perf_counter()
        prof["build"] += _t1 - _t0
        prof["compute"] += _t2 - _t1
        prof["readback"] += _t3 - _t2
        prof["runs"] += 1
        prof["per_run"].append((_t1 - _t0, _t2 - _t1, _t3 - _t2,
                                int(Npad), int(obs.shape[1])))
        # only read back points constrained by >=2 in-window observations:
        # a point with a single in-window residual is underdetermined along
        # its viewing ray; the solver moves it freely, and reading that
        # back corrupts the global map (found at the 10k x 500 f32 run:
        # localization decayed between global BA runs until it failed)
        n_inwin = inwin[:Np].sum(axis=1)
        for i, t in enumerate(tids):
            if n_inwin[i] >= 2:
                self.point_coords[t] = pts_o[i]
                self._ba_points.add(int(t))
        for k in range(2, window):         # pinned 0,1 unchanged by solve
            self.cam_cfw_R[base + k] = R_o[k]
            self.cam_cfw_t[base + k] = t_o[k]
        return True

    def _closure_similarity(self, A: np.ndarray, B: np.ndarray):
        """(s, R, t) host arrays with B ~ s R A + t: LMedS-robust with
        MAD-gated refits from 6 pairs up (the inlier count lands in
        ``last_closure_inliers``), least squares below or where the robust
        fit is not finite. One read per fit."""
        A_d, B_d = self._send(A, B)
        n_meas = len(A)
        if n_meas >= 6:
            s_u, R_u, t_u, inl = align.umeyama_similarity_robust(A_d, B_d)
            s, R, t, inl = fetch(s_u, R_u, t_u, inl)
            if np.isfinite(s) and np.isfinite(R).all() and np.isfinite(t).all():
                self.last_closure_inliers = int(np.sum(inl))
                return float(s), R, t
            # a NaN Sim(3) edge would make the pose-graph LM reject every
            # step: the closure would silently no-op while returning
            # ok=True; fall back to the plain LS fit
        s, R, t = fetch(*align.umeyama_similarity(A_d, B_d))
        self.last_closure_inliers = n_meas
        return float(s), R, t

    def close_loop_sim3(self, tail_frames, head_frames, *, pairs=None,
                        min_common: int = 8, odometry_weight: float = 1.0,
                        closure_weight: float = 10.0, iters: int = 40,
                        run_ba: bool = False) -> tuple[bool, int]:
        """Monocular loop closure over a Sim(3) pose graph (new capability;
        SE(3) graphs cannot absorb the SCALE drift a monocular chain
        accumulates, Strasdat RSS'10; the reference has no closure at all).

        The closure measurement is the similarity between two estimates of
        the same physical points: their TAIL-side map positions (drifted)
        vs their HEAD-side positions (early scale). ``pairs`` =
        [(tail_tid, head_tid)] supplies the correspondence (re-detected
        tracks at a revisit matched to the original tracks). Appearance
        matching carries a few-percent gross-outlier rate, so the fit is
        LMedS-robust with MAD-gated inlier refits
        (geom/align.umeyama_similarity_robust) rather than plain least
        squares; the surviving inlier count lands in
        ``self.last_closure_inliers``. Without ``pairs``, seam tracks
        observed in both frame sets are used, with the head-side positions
        re-triangulated from the head frames only.

        The similarity becomes Sim(3) closure edges; odometry edges come
        from the current consecutive poses (rel scale 1). After optimizing,
        the whole map is re-triangulated under the corrected poses and
        (optionally) a global BA with the seam frames pinned re-polishes.
        Returns (ok, n_common)."""
        ts = self.track_store
        if pairs is not None:
            good = [(int(a), int(b)) for a, b in pairs
                    if int(a) in self.point_coords
                    and int(b) in self.point_coords]
            if len(good) < min_common:
                return False, len(good)
            A = np.stack([self.point_coords[a] for a, _ in good])  # drifted
            B = np.stack([self.point_coords[b] for _, b in good])  # early
            n_meas = len(good)
        else:
            head_set = set()
            for f in head_frames:
                head_set.update(int(t) for t in ts.tracks_in_frame(int(f)))
            common = sorted({int(t) for f in tail_frames
                             for t in ts.tracks_in_frame(int(f))
                             if int(t) in head_set
                             and int(t) in self.point_coords})
            if len(common) < min_common:
                return False, len(common)
            h = max(int(f) for f in head_frames)
            tri = self._triangulate_tracks(common, h)  # head-side positions
            common = [t for t in common if t in tri]
            if len(common) < min_common:
                return False, len(common)
            A = np.stack([self.point_coords[t] for t in common])   # drifted
            B = np.stack([tri[t] for t in common])                 # early
            n_meas = len(common)
        U = self._closure_similarity(A, B)
        self.last_closure_similarity = U

        n = self.frames_count()
        R_w, t_w = self._world_from_cameras()
        edges = []
        for k in range(n - 1):
            rel_R = R_w[k].T @ R_w[k + 1]
            rel_t = R_w[k].T @ (t_w[k + 1] - t_w[k])
            edges.append((k, k + 1, rel_R, rel_t, 1.0, odometry_weight))
        for i in tail_frames:
            Ci = posegraph.sim3_compose(U, (1.0, R_w[int(i)], t_w[int(i)]))
            for j in head_frames:
                Z = posegraph.sim3_compose(posegraph.sim3_inverse(Ci),
                                           (1.0, R_w[int(j)], t_w[int(j)]))
                edges.append((int(i), int(j), Z[1], Z[2], Z[0],
                              closure_weight))
        g = posegraph.make_sim3_graph(R_w, t_w, edges, device=self.device,
                                      dtype=self.dtype)
        self._set_from_world(posegraph.optimize_sim3_graph(
            g, iters=iters, device_loop=self.ba_device_loop))
        tri_all = self._triangulate_tracks(list(self.point_coords), n - 1)
        self.point_coords.update(tri_all)
        if run_ba:
            pins = tuple(sorted({int(i) for i in tail_frames}
                                | {int(j) for j in head_frames}))
            self.run_global_ba(pin_frames=pins)
        return True, n_meas

    def _use_sparse(self) -> bool:
        if self.use_sparse_ba is not None:
            return bool(self.use_sparse_ba)
        return (len(self.point_coords) * self.frames_count()
                > self.sparse_ba_threshold)

    def _unity_comp_ind(self) -> int:
        """Gauge scale is anchored on ONE component of the cam0->cam1 shift
        (SceneNormalizer, bundle-adj-kanatani.cpp:203): normalization divides
        the world by it, so a near-zero component blows the gauge up and
        leaves the scale effectively unconstrained. Pick the largest."""
        R0, T0 = self.cam_cfw_R[0], self.cam_cfw_t[0]
        R1, T1 = self.cam_cfw_R[1], self.cam_cfw_t[1]
        T01 = T0 - R0 @ (R1.T @ T1)
        return int(np.argmax(np.abs(T01)))

    @spanned("ba.global")
    def run_global_ba(self, pin_frames: tuple = ()) -> None:
        """Global BA over every frame and point (the sparse Schur path at
        scale, its shapes padded to ``ba_point_bucket`` points and
        ``ba_frame_bucket`` frames), ``pin_frames`` held fixed; the map and
        the poses take its result if it converged."""
        prof = self._profile("global_ba")
        _t0 = time.perf_counter()
        term = TermCriteria(
            allowed_reproj_err_rel_change=self.ba_term_rel_change,
            max_iters=self.ba_max_iters)
        uci = self._unity_comp_ind()
        self.last_ba_sparse = self._use_sparse()
        if self.last_ba_sparse:
            n_f = self.frames_count()
            n_dev = (1 if self.ba_group is None
                     else dist.get_world_size(self.ba_group))
            with span("ba.build"):
                tids, p = self._sparse_problem(
                    pad_points=self.ba_point_bucket or max(8 * n_dev, 8),
                    pad_frames=self.ba_frame_bucket)
            pins = tuple(pin_frames) + tuple(range(n_f, p.n_frames))
            key = (p.n_points, p.n_frames, pins, uci)
            ba = self._ba_cache.get(key)
            if ba is None:
                ba = SparseBundleAdjustment(
                    optimize_intrinsics=False, pin_frames=pins,
                    point_chunk=self.ba_point_chunk, unity_comp_ind=uci,
                    group=self.ba_group, device_loop=self.ba_device_loop)
                # only the newest: each run plans its bands anew, so an
                # older BA's plan and the CUDA graphs captured for it
                # serve no later run, and their memory goes
                self._ba_cache = {key: ba}
            ba.set_plan_inputs(*self._last_sparse_inputs)
            _t1 = time.perf_counter()
            ok, p_opt = ba.compute_inplace(p, term)
        else:
            tids, p = self._dense_problem()
            ba = BundleAdjustment(optimize_intrinsics=False,
                                  pin_frames=pin_frames, unity_comp_ind=uci)
            _t1 = time.perf_counter()
            ok, p_opt = ba.compute_inplace(p, term)
        _t2 = time.perf_counter()
        self.ba_runs += 1
        self._log_ba("sparse" if self.last_ba_sparse else "dense", ok, ba)
        if not ok:
            return
        pts, R_opt, t_opt = fetch(p_opt.points, p_opt.cfw_R, p_opt.cfw_t)
        _t3 = time.perf_counter()
        prof["build"] += _t1 - _t0
        prof["compute"] += _t2 - _t1
        prof["readback"] += _t3 - _t2
        prof["runs"] += 1
        prof["per_run"].append((_t1 - _t0, _t2 - _t1, _t3 - _t2,
                                int(p.n_points), int(p.n_frames)))
        for i, t in enumerate(tids):
            self.point_coords[t] = pts[i]
        self._ba_points.update(int(t) for t in tids)
        # the gauge round trip maps R_0 to R_0 R_0^T R_0 (normalize.py), so
        # a rotation's departure from SO(3) would triple with every global
        # BA: in float32 that reaches ~1e-2 in ten runs, and a pinned frame
        # then moves (ROADMAP C.3). The JAX package keeps the rotations as
        # they come back; the port takes the nearest rotations.
        R_opt = _nearest_rotations(R_opt)
        for f in range(self.frames_count()):
            self.cam_cfw_R[f] = R_opt[f]
            self.cam_cfw_t[f] = t_opt[f]

    _run_ba = run_global_ba      # the JAX package's name
