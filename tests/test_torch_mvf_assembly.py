"""The factorizer's host-side input assembly (``find_anchor_frame``,
``_localization_inputs``, ``_tri_candidates`` + ``_assemble_tri_batch``
and ``_accept_triangulations``), whole-array numpy, against the per-track
loops of the same steps, kept here as the oracle: the same anchor, the same
shared tracks in the same order, masks and indices exactly, float64 arrays
to 1e-12, and the accepted points in the candidates' order.

Held on every keyframe of a short pass of the demo's world (CPU, float64),
on the whole map at its end (the closure's re-triangulation), and on small
hand-made track stores for the edge cases: no candidate, one candidate, a
corner re-reported in its frame, a track at capacity, observations after
the frame a triangulation stops at (written out of order, so the selected
slots are no prefix), and two anchor frames that tie.
"""

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch.demos import mvf_at_scale
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.mvf import TrackStore
from surikatoko_tpu_torch.models.mvf.factorizer import (
    MultiViewFactorizer, _bucket)
from surikatoko_tpu_torch.models.mvf.session import MvfSession

torch.set_num_threads(2)

FLOAT_TOL = 1e-12


# ---- the oracle: the per-track loops --------------------------------------

def loop_anchor(mvf, new_frame):
    ts = mvf.track_store
    cur = [t for t in ts.tracks_in_frame(new_frame)
           if int(t) in mvf.point_coords]
    counts = np.zeros(max(new_frame, 1), np.int64)
    for tid in cur:
        fr = ts.frames_of(int(tid))
        fr = fr[fr < new_frame]
        counts[fr] += 1
    anchor = int(np.argmax(counts)) if new_frame > 0 else 0
    common = np.asarray([t for t in cur if ts.slot_of(int(t), anchor) >= 0],
                        int)
    return anchor, common


def loop_localization_inputs(mvf, new_frame):
    ts = mvf.track_store
    anchor, common = loop_anchor(mvf, new_frame)
    if len(common) == 0:
        return None
    Ra, ta = mvf.cam_cfw_R[anchor], mvf.cam_cfw_t[anchor]
    pts = np.stack([mvf.point_coords[int(t)] for t in common])
    depths = (pts @ Ra.T + ta)[:, 2]
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
            mvf.cam_cfw_R[-1], mvf.cam_cfw_t[-1])


def loop_candidates(mvf, tids, upto_frame):
    ts = mvf.track_store
    cands = []
    for tid in tids:
        fr = ts.frames_of(int(tid))
        sel = np.nonzero(fr <= upto_frame)[0]
        if len(sel) >= 2:
            cands.append((int(tid), sel))
    return cands


def loop_batch(mvf, cands):
    ts = mvf.track_store
    n_have = len(mvf.cam_cfw_R)
    R_all = np.stack(mvf.cam_cfw_R)
    t_all = np.stack(mvf.cam_cfw_t)
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
        base = int(fr[0])
        Rb, tb = R_all[base], t_all[base]
        others = fr[1:]
        is_new_o = others >= n_have
        safe_o = np.where(is_new_o, 0, others)
        k = len(others)
        x_base[i] = ts.coords[tid, sel[0]]
        xs[i, :k] = ts.coords[tid, sel[1:]]
        R_fb[i, :k] = R_all[safe_o] @ Rb.T
        T_fb[i, :k] = t_all[safe_o] - np.einsum("fij,j->fi", R_fb[i, :k], tb)
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


def loop_accept(mvf, cands, packed):
    x_out, depth, par = packed[:, :3], packed[:, 3], packed[:, 4]
    out = {}
    for i, (tid, _) in enumerate(cands):
        if (depth[i] > 0 and np.isfinite(x_out[i]).all()
                and par[i] >= mvf.min_parallax_ratio):
            out[tid] = x_out[i]
    return out


# ---- the comparison -------------------------------------------------------

def _same_arrays(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(i))


def _packed(rng, n_rows, min_par):
    """A triangulation result with every kind of row the acceptance
    rejects: behind the camera, not finite, too little parallax."""
    p = rng.normal(size=(n_rows, 5))
    p[:, 3] = rng.uniform(-1.0, 3.0, n_rows)
    p[:, 4] = rng.uniform(0.0, 4 * min_par, n_rows)
    p[rng.random(n_rows) < 0.1, rng.integers(0, 3)] = np.nan
    return p


def check_assembly(mvf, new_frame, tids, upto_frame, mark_frame, rng):
    """Every assembly step at ``new_frame`` (anchor and localization) and
    for the triangulation of ``tids`` up to ``upto_frame`` equals the
    loops'. Returns (number of candidates, number of shared tracks)."""
    anchor, common = mvf.find_anchor_frame(new_frame)
    anchor_w, common_w = loop_anchor(mvf, new_frame)
    assert anchor == anchor_w
    assert common.dtype == common_w.dtype
    assert common.tolist() == common_w.tolist()
    loc = mvf._localization_inputs(new_frame)
    loc_w = loop_localization_inputs(mvf, new_frame)
    assert (loc is None) == (loc_w is None)
    if loc is not None:
        _same_arrays(loc, loc_w)

    tids_c, sel = mvf._tri_candidates(tids, upto_frame)
    cands_w = loop_candidates(mvf, tids, upto_frame)
    assert tids_c.tolist() == [t for t, _ in cands_w]
    assert sel.shape == (len(tids_c), mvf.track_store.L)
    for row, (_, s) in zip(sel, cands_w):
        assert np.nonzero(row)[0].tolist() == s.tolist()
    if not cands_w:
        assert mvf._triangulate_tracks(tids, upto_frame) == {}
        return 0, len(common)
    batch = mvf._assemble_tri_batch((tids_c, sel), mark_frame=mark_frame)
    _same_arrays(batch, loop_batch(mvf, cands_w))
    packed = _packed(rng, batch[0].shape[0], mvf.min_parallax_ratio)
    acc = mvf._accept_triangulations((tids_c, sel), packed)
    acc_w = loop_accept(mvf, cands_w, packed)
    assert list(acc) == list(acc_w)
    assert all(type(t) is int for t in acc)
    for t in acc_w:
        np.testing.assert_array_equal(acc[t], acc_w[t])
    return len(cands_w), len(common)


# ---- a short pass of the demo's world -------------------------------------

def test_torch_mvf_assembly_matches_loops_on_a_pass():
    args = mvf_at_scale.make_args(points=240, frames=20, revisit_frames=0,
                                  oracle_pairs=True, seed=2147483659,
                                  device="cpu")
    w = mvf_at_scale.World(args)
    ts = TrackStore(2 * w.n_pts, w.n_total, 2 * args.track_len)
    s = MvfSession(ts, mvf_at_scale.K, base_frames=w.n_base, window=8,
                   window_ba_every=5, global_ba_every=0, global_ba_iters=5,
                   point_bucket=64, frame_bucket=8, pr_ransac_thresh=0.25,
                   device="cpu", dtype=torch.float64)
    mvf = s.mvf
    rng = np.random.default_rng(0)
    n_cands = n_common = 0
    for f in range(w.n_total):
        w.write_corners(ts, f)
        if f < 2:
            tids = ts.tracks_in_frame(f)
            s.known_frame(SE3(w.Rs[f], w.ts_gt[f]), tids, w.pts_gt[tids])
            continue
        a, b = check_assembly(mvf, f, mvf._fresh_tracks(f), f, f, rng)
        n_cands, n_common = n_cands + a, n_common + b
        assert s.frame(f), f
    # the closure's call: the whole map up to the last frame
    n = mvf.frames_count()
    a, _ = check_assembly(mvf, n - 1, list(mvf.point_coords), n - 1, None,
                          rng)
    assert a > 200 and n_cands > 200 and n_common > 500


# ---- hand-made stores for the edge cases ----------------------------------

def _rot(rng):
    q, _ = np.linalg.qr(np.eye(3) + 0.05 * rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(q))[None, :]


def _store(n_poses, tracks, L=4):
    """A factorizer with ``n_poses`` poses (cameras ~5 units from the
    origin) and ``tracks`` = {tid: [(frame, has_point), ...]}, each corner
    written in the order given; a track has a point where any entry says
    so."""
    rng = np.random.default_rng(7)
    ts = TrackStore(max_tracks=16, max_frames=16, max_track_len=L)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    mvf = MultiViewFactorizer(track_store=ts, K=K, device="cpu",
                              dtype=torch.float64)
    for _ in range(n_poses):
        mvf.add_known_frame(SE3(_rot(rng), np.array([0.1, -0.1, 5.0])
                                + 0.1 * rng.normal(size=3)))
    K_inv = np.linalg.inv(K)
    for tid, entries in tracks.items():
        for f, has_point in entries:
            ts.add_corner(tid, f, rng.uniform(100, 400, 2), K_inv)
            if has_point:
                mvf.point_coords[tid] = rng.normal(scale=0.5, size=3)
    return mvf, rng


# new frame 4 (poses of frames 0-3 exist); (frame, has_point)
EDGE = {
    # no track has two observations up to frame 4
    "no_candidate": (dict(tids=[5, 6], upto=4), {
        1: [(0, True), (2, True), (4, True)], 2: [(1, True), (4, True)],
        5: [(4, False)], 6: [(3, False)]}),
    "one_candidate": (dict(tids=[5, 6], upto=4), {
        1: [(0, True), (2, True), (4, True)], 2: [(1, True), (4, True)],
        5: [(1, False), (2, False), (4, False)], 6: [(4, False)]}),
    # track 5's corner at frame 4 reported twice: the second overwrites
    "rereported": (dict(tids=[5, 1], upto=4), {
        1: [(0, True), (2, True), (4, True)], 2: [(1, True), (4, True)],
        5: [(1, False), (3, False), (4, False), (4, False)]}),
    # track 5 full at L = 4 before frame 4: its frame-4 corner is dropped
    "capacity": (dict(tids=[5, 3], upto=4), {
        1: [(0, True), (2, True), (4, True)], 2: [(1, True), (4, True)],
        5: [(0, False), (1, False), (2, False), (3, False), (4, False)],
        3: [(0, True), (1, True), (2, True), (4, True)]}),
    # triangulating up to frame 2: track 5 written as 3, 1, 2, 4 keeps
    # slots 1 and 2 (no prefix), track 6 keeps only frame 0
    "after_upto": (dict(tids=[5, 6, 1], upto=2), {
        1: [(0, True), (2, True), (4, True)], 2: [(1, True), (4, True)],
        5: [(3, False), (1, False), (2, False), (4, False)],
        6: [(0, False), (3, False), (4, False)]}),
    # frames 1 and 2 each share two tracks with frame 4: frame 1 wins
    "anchor_tie": (dict(tids=[5], upto=4), {
        1: [(2, True), (4, True)], 2: [(1, True), (4, True)],
        3: [(1, True), (3, True), (4, True)], 4: [(2, True), (4, True)],
        5: [(0, False), (4, False)]}),
}


@pytest.mark.parametrize("case", list(EDGE))
@pytest.mark.parametrize("mark", [True, False], ids=["mark", "nomark"])
def test_torch_mvf_assembly_matches_loops_edge(case, mark):
    spec, tracks = EDGE[case]
    mvf, rng = _store(4, tracks)
    ts = mvf.track_store
    upto = spec["upto"] if mark else min(spec["upto"], 3)
    a, _ = check_assembly(mvf, 4, spec["tids"], upto, 4 if mark else None,
                          rng)
    want = {"no_candidate": 0, "one_candidate": 1}.get(case)
    if want is not None:
        assert a == want
    if case == "rereported":
        assert ts.count[5] == 3 and ts.frames_of(5).tolist() == [1, 3, 4]
    if case == "capacity":
        assert ts.count[5] == ts.L and 4 not in ts.frames_of(5).tolist()
    if case == "anchor_tie":
        assert mvf.find_anchor_frame(4)[0] == 1
