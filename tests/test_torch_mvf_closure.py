"""Loop closure and the moderate-scale incremental run of the PyTorch port
against the JAX package, in float64 on the CPU.

- ``close_loop_sim3`` on test_sim3_posegraph.py:245's revisit world (an
  80-frame open orbit of 800 points, tracks of 8, 0.5 px, then a 10-frame
  revisit re-detecting the head landmarks as new tracks, oracle pairs, the
  pinned global BA after the Sim(3) graph): the JAX run's state before the
  closure carried into the port, both closed, poses and map within 1e-8.
  The port is handed the JAX package's robust similarity here (the two
  packages draw other random triples, geom/align.py); with its own fit it
  must close the loop as the JAX test asks, also with 15% wrong pairs.
- test_mvf_sparse.py:96's moderate-scale run (600 points, 40 frames, tracks
  of 10, sliding-window BA every 5 frames, the banded sparse global BA at
  the end): map ATE < 0.1 in both packages, each frame's corners into both,
  the end states within 1e-8.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import se3 as jse3
from surikatoko_tpu.geom.align import umeyama_similarity_robust as j_robust
from surikatoko_tpu.geom.se3 import SE3 as JSE3
from surikatoko_tpu.models.mvf import MultiViewFactorizer as JMVF
from surikatoko_tpu.models.mvf import TrackStore as JTS
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.geom import align as talign
from surikatoko_tpu_torch.geom.align import aligned_rmse
from surikatoko_tpu_torch.models.mvf import MultiViewFactorizer as TMVF
from surikatoko_tpu_torch.models.mvf import TrackStore as TTS

from test_mvf import K, K_INV
from test_torch_mvf import MVF_TOL, compare, snapshot

torch.set_num_threads(2)


def _orbit(n_frames, n_base, radius, height):
    Rs, ts = [], []
    for k in range(n_frames):
        a = 2 * np.pi * (k % n_base) / n_base
        eye = np.array([radius * np.cos(a), radius * np.sin(a), height])
        cfw = jse3.look_at_luf_wfc(jnp.asarray(eye),
                                   jnp.asarray([0.0, 0, height]),
                                   jnp.asarray([0.0, 0, 1])).inv()
        Rs.append(np.asarray(cfw.R))
        ts.append(np.asarray(cfw.t))
    return np.stack(Rs), np.stack(ts)


def _ate(m, gt_pos):
    pos = np.stack([-R.T @ t for R, t in zip(m.cam_cfw_R, m.cam_cfw_t)])
    return float(aligned_rmse(torch.as_tensor(pos), torch.as_tensor(gt_pos)))


def _robust_from_jax(src, dst, **kw):
    out = j_robust(jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()), **kw)
    return tuple(torch.as_tensor(np.asarray(x)) for x in out)


@pytest.fixture(scope="module")
def revisit():
    """The JAX run of test_mvf_sim3_loop_closure_fixes_ring_drift up to
    the closure: (factorizer, GT positions, n_pts, n_base, n_frames)."""
    rng = np.random.default_rng(1)
    n_base, n_revisit, n_pts, L = 80, 10, 800, 8
    n_frames = n_base + n_revisit
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    pts = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang),
                    rng.uniform(0, 1.0, n_pts)], axis=1)
    Rs, ts_ = _orbit(n_frames, n_base, 6.0, 0.5)
    facing = (ang / (2 * np.pi) * n_base).astype(int)
    ts = JTS(max_tracks=2 * n_pts, max_frames=n_frames, max_track_len=2 * L)
    mvf = JMVF(track_store=ts, K=K, use_sparse_ba=True, ba_max_iters=15,
               ba_term_rel_change=None, ba_trigger_reproj_err=float("inf"))
    for f in range(n_frames):
        fm = f % n_base
        for tid in range(n_pts):
            c = int(facing[tid])
            vis = (c <= f < c + L) if f < n_base else ((fm - c) % n_base) < L
            if not vis:
                continue
            xc = Rs[f] @ pts[tid] + ts_[f]
            if xc[2] < 0.5:
                continue
            ph = K @ xc
            pix = ph[:2] / ph[2] + rng.normal(scale=0.5, size=2)
            if f >= n_base and facing[tid] < n_base // 2:
                ts.add_corner(n_pts + tid, f, pix, K_INV)
            else:
                ts.add_corner(tid, f, pix, K_INV)
        if f < 2:
            mvf.add_known_frame(JSE3(jnp.asarray(Rs[f]), jnp.asarray(ts_[f])))
            for tid in ts.tracks_in_frame(f):
                mvf.set_known_point(int(tid), pts[tid])
        else:
            mvf.integrate_new_frame_corners()
    pos_gt = np.stack([-R.T @ t for R, t in zip(Rs, ts_)])
    return mvf, pos_gt, n_pts, n_base, n_frames


def _close(m, n_pts, n_base, n_frames, pairs=None):
    pairs = pairs or [(n_pts + tid, tid) for tid in range(n_pts)]
    return m.close_loop_sim3(tail_frames=range(n_base, n_frames),
                             head_frames=range(6), pairs=pairs, run_ba=True)


def test_torch_close_loop_sim3_matches_jax(revisit, monkeypatch):
    j0, pos_gt, n_pts, n_base, n_frames = revisit
    t = interop.mvf_from_numpy(j0, device="cpu")
    j = copy.deepcopy(j0)
    ate_before = _ate(t, pos_gt)
    assert ate_before > 0.1
    ok_j, n_j = _close(j, n_pts, n_base, n_frames)
    monkeypatch.setattr(talign, "umeyama_similarity_robust", _robust_from_jax)
    ok_t, n_t = _close(t, n_pts, n_base, n_frames)
    assert ok_j and ok_t and n_j == n_t
    assert t.last_closure_inliers == j.last_closure_inliers
    compare(snapshot(j), snapshot(t), MVF_TOL, "after the closure")
    assert t.ba_log[-1][:2] == ("sparse", True)
    assert _ate(t, pos_gt) < 0.5 * ate_before


def test_torch_close_loop_sim3_own_fit_and_wrong_pairs(revisit):
    """The port's own robust fit closes the loop, and ~15% wrong pairs
    (test_sim3_posegraph.py:338-361) land where the clean closure did."""
    j0, pos_gt, n_pts, n_base, n_frames = revisit
    t = interop.mvf_from_numpy(j0, device="cpu")
    dirty = interop.mvf_from_numpy(j0, device="cpu")
    ate_before = _ate(t, pos_gt)
    ok, _ = _close(t, n_pts, n_base, n_frames)
    ate_after = _ate(t, pos_gt)
    assert ok and ate_after < 0.5 * ate_before, (ate_before, ate_after)
    pairs = [(n_pts + tid, tid) for tid in range(n_pts)]
    present = [p for p in pairs if p[0] in dirty.point_coords
               and p[1] in dirty.point_coords]
    n_bad = max(2, len(present) * 15 // 100)
    corrupted = list(present)
    for i in range(n_bad):
        corrupted[i] = (corrupted[i][0],
                        corrupted[(i + len(present) // 2) % len(present)][1])
    ok2, _ = _close(dirty, n_pts, n_base, n_frames, corrupted)
    assert ok2
    assert _ate(dirty, pos_gt) < max(1.3 * ate_after, 0.05)
    assert dirty.last_closure_inliers <= len(present) - n_bad + 2


def test_torch_mvf_moderate_scale_matches_jax():
    """test_mvf_incremental_at_moderate_scale in both packages side by
    side: map ATE < 0.1 in each, the same map, and the end states within
    1e-8."""
    rng = np.random.default_rng(0)
    n_frames, n_pts, L = 40, 600, 10
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    pts = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang),
                    rng.uniform(0, 1.0, n_pts)], axis=1)
    Rs, ts_ = [], []
    for a in np.linspace(0, 2 * np.pi, n_frames, endpoint=False):
        eye = np.array([6.0 * np.cos(a), 6.0 * np.sin(a), 0.5])
        cfw = jse3.look_at_luf_wfc(jnp.asarray(eye), jnp.asarray([0.0, 0, 0.5]),
                                   jnp.asarray([0.0, 0, 1])).inv()
        Rs.append(np.asarray(cfw.R))
        ts_.append(np.asarray(cfw.t))
    facing = (ang / (2 * np.pi) * n_frames).astype(int)
    kw = dict(K=K, use_sparse_ba=True, ba_max_iters=10,
              ba_term_rel_change=None, ba_trigger_reproj_err=1e9)
    j = JMVF(track_store=JTS(n_pts, n_frames, L), **kw)
    t = TMVF(track_store=TTS(n_pts, n_frames, L), device="cpu", **kw)
    for f in range(n_frames):
        for tid in range(n_pts):
            if not ((facing[tid] - f) % n_frames < L):
                continue
            xc = Rs[f] @ pts[tid] + ts_[f]
            if xc[2] < 0.5:
                continue
            ph = K @ xc
            pix = ph[:2] / ph[2] + rng.normal(scale=0.3, size=2)
            for m in (j, t):
                m.track_store.add_corner(tid, f, pix, K_INV)
        for m in (j, t):
            if f < 2:
                m.add_known_frame(JSE3(jnp.asarray(Rs[f]), jnp.asarray(ts_[f])))
                for tid in m.track_store.tracks_in_frame(f):
                    m.set_known_point(int(tid), pts[tid])
            else:
                m.integrate_new_frame_corners()
                if (f + 1) % 5 == 0:
                    m.run_windowed_ba(window=16, point_bucket=256)
    assert len(t.point_coords) == len(j.point_coords) > 0.8 * n_pts
    for m in (j, t):
        m._run_ba()
        assert m.last_ba_sparse
    a, b = snapshot(j), snapshot(t)
    d = compare(a, b, np.inf)
    for s in (a, b):
        tids = sorted(s["points"])
        est = np.stack([s["points"][k] for k in tids])
        assert float(aligned_rmse(torch.as_tensor(est),
                                  torch.as_tensor(pts[tids]))) < 0.1
    assert d <= MVF_TOL, d
