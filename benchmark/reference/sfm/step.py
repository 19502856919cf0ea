"""One step of the incremental SfM pass from a given state: which
correspondences, tracks, frames and points each part takes, and what it
keeps. The state is the pipeline's own (poses of the frames so far, the
map, which of its points a bundle adjustment has refined); the
observations are the pass's, ``Obs``.

- ``integrate``: keyframe f's pose and the points of its fresh tracks.
  The anchor is the earlier frame that sees most of f's mapped tracks (the
  first such); the correspondences are the mapped tracks f shares with it,
  those in front of the anchor. The pose starts from the previous frame's.
  Fresh tracks are f's tracks without a point or whose point no
  adjustment has refined yet; each with two or more observations so far is
  triangulated and kept by the rule in ``triangulate``.
- ``window_ba``: the last ``window`` frames and every mapped track they
  see, in-window observations only, the window's first two frames fixed;
  it writes back the poses of the others and the points with two or more
  in-window observations.
- ``global_ba``: every frame and point, in Kanatani's normalized world
  (the first camera fixed and one position component of the second, the
  larger of the first camera's view of the second's centre); it writes
  back everything.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import ba
from .geometry import normalized
from .pnp import pnp_gn
from .triangulate import dlt, first_view_depth, parallax_ratio, refine

MIN_DEPTH = 1e-6       # an anchor depth at most this is behind the camera


class Obs(NamedTuple):
    """The pass's observations: ``frames[tid]`` (ascending) and
    ``pix[tid]`` ([n, 2]) of each track, ``frame_tids[f]`` the tracks of
    frame f in the order the frame reported them."""
    frames: dict
    pix: dict
    frame_tids: list


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                           device=device)


def _padded(obs: Obs, tids, upto: int, R, t, K):
    """[N, M] tracks' poses, normalized coordinates and mask of their
    observations at frames <= upto (pad slots repeat the first)."""
    sel = [obs.frames[tid] <= upto for tid in tids]
    M = max(int(s.sum()) for s in sel)
    idx = np.zeros((len(tids), M), np.int64)
    pix = np.zeros((len(tids), M, 2))
    mask = np.zeros((len(tids), M), bool)
    for i, (tid, s) in enumerate(zip(tids, sel)):
        fr, px = obs.frames[tid][s], obs.pix[tid][s]
        n = len(fr)
        idx[i, :n], idx[i, n:] = fr, fr[0]
        pix[i, :n], pix[i, n:] = px, px[0]
        mask[i, :n] = True
    idx = torch.as_tensor(idx, device=R.device)
    x = normalized(K, _t(pix, R.dtype, R.device))
    return R[idx], t[idx], x, torch.as_tensor(mask, device=R.device)


def integrate(K, R, t, points: dict, refined: set, obs: Obs, f: int,
              min_parallax: float):
    """Keyframe ``f`` after frames 0..f-1 with poses (R, t) [f, 3, 3], [f,
    3]: its pose (R_f, t_f) and {tid: point} of the fresh tracks kept, or
    None where no correspondence can localize it."""
    dtype, dev = R.dtype, R.device
    cur = [tid for tid in obs.frame_tids[f] if tid in points]
    counts = np.zeros(f, np.int64)
    for tid in cur:
        fr = obs.frames[tid]
        counts[fr[fr < f]] += 1
    anchor = int(np.argmax(counts))
    common = [tid for tid in cur if np.any(obs.frames[tid] == anchor)]
    if not common:
        return None
    X = _t(np.stack([points[tid] for tid in common]), dtype, dev)
    depth = (X @ R[anchor].T + t[anchor])[:, 2]
    good = torch.isfinite(depth) & (depth > MIN_DEPTH)
    if not bool(good.any()):
        return None
    px = np.stack([obs.pix[tid][obs.frames[tid] == f][0] for tid in common])
    x_f = normalized(K, _t(px, dtype, dev))
    R_f, t_f = pnp_gn(X[good], x_f[good], R[f - 1], t[f - 1])

    fresh = [tid for tid in obs.frame_tids[f]
             if tid not in points or tid not in refined]
    cands = [tid for tid in fresh if np.sum(obs.frames[tid] <= f) >= 2]
    new = {}
    if cands:
        R_all = torch.cat([R, R_f[None]])
        t_all = torch.cat([t, t_f[None]])
        Rc, tc, x, mask = _padded(obs, cands, f, R_all, t_all, K)
        Xc = refine(dlt(Rc, tc, x, mask), Rc, tc, x, mask)
        d1 = first_view_depth(Rc, tc, x, mask)
        d_ok = torch.isfinite(d1) & (d1 > 0)
        ratio = parallax_ratio(Rc, tc, mask,
                               torch.where(d_ok, d1, torch.ones_like(d1)))
        keep = d_ok & (ratio >= min_parallax) & torch.isfinite(Xc).all(-1)
        new = {tid: Xc[i] for i, tid in enumerate(cands) if bool(keep[i])}
    return R_f, t_f, new


class Adjusted(NamedTuple):
    """A bundle adjustment's problem and what it writes back: its frames
    (global indices), points (track ids), the free frames and the points
    written (as positions in those lists), and the reference's result."""
    problem: ba.Problem
    frames: list
    tids: list
    pose_written: list
    point_written: list
    result: ba.Result


def _problem(K, obs: Obs, tids, frames, free):
    pos = {f: i for i, f in enumerate(frames)}
    pt, cam, pix = [], [], []
    for i, tid in enumerate(tids):
        for fr, px in zip(obs.frames[tid], obs.pix[tid]):
            if int(fr) in pos:
                pt.append(i)
                cam.append(pos[int(fr)])
                pix.append(px)
    dev = free.device
    return ba.problem(K, torch.as_tensor(pt, device=dev),
                      torch.as_tensor(cam, device=dev),
                      _t(np.stack(pix), K.dtype, dev), free)


def window_ba(K, R, t, points: dict, obs: Obs, window: int,
              max_iters: int) -> Adjusted | None:
    """The sliding-window adjustment after frames 0..F-1 (poses (R, t)),
    or None where fewer than ``window`` frames or no point."""
    F = R.shape[0]
    if F < window:
        return None
    frames = list(range(F - window, F))
    tids = sorted({tid for f in frames for tid in obs.frame_tids[f]}
                  & set(points))
    if not tids:
        return None
    free = torch.ones(window, 6, dtype=torch.bool, device=R.device)
    free[:2] = False
    pb = _problem(K, obs, tids, frames, free)
    X = _t(np.stack([points[tid] for tid in tids]), R.dtype, R.device)
    res = ba.levenberg_marquardt(pb, X, R[F - window:], t[F - window:],
                                 max_iters)
    n_in = torch.bincount(pb.pt, minlength=len(tids))
    written = [i for i in range(len(tids)) if int(n_in[i]) >= 2]
    return Adjusted(pb, frames, tids, list(range(2, window)), written, res)


def gauge_component(R, t) -> int:
    """The component of the second camera's centre in the first camera
    (the larger in size) that the normalized world sets to 1."""
    t01 = t[0] - R[0] @ (R[1].T @ t[1])
    return int(torch.argmax(torch.abs(t01)))


def global_ba(K, R, t, points: dict, obs: Obs, max_iters: int) -> Adjusted:
    """The global adjustment after frames 0..F-1 (poses (R, t))."""
    F = R.shape[0]
    tids = sorted(points)
    uci = gauge_component(R, t)
    free = torch.ones(F, 6, dtype=torch.bool, device=R.device)
    free[0] = False
    free[1, uci] = False
    frames = list(range(F))
    pb = _problem(K, obs, tids, frames, free)
    X = _t(np.stack([points[tid] for tid in tids]), R.dtype, R.device)
    Xn, Rn, tn, gauge = ba.normalize(X, R, t, uci)
    res = ba.levenberg_marquardt(pb, Xn, Rn, tn, max_iters)
    Xo, Ro, to = ba.revert(res.X, res.R, res.t, gauge)
    res = res._replace(X=Xo, R=Ro, t=to)
    return Adjusted(pb, frames, tids, frames, list(range(len(tids))), res)
