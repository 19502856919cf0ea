"""Sparse (padded-track) BA for the at-scale configuration.

Port of ``surikatoko_tpu/models/ba/sparse.py``. Observations are
track-major: each point carries up to L observing frames (padded):

  obs [Np, L, 2], frame_idx [Np, L] int64, obs_mask [Np, L]

Gauss-Newton blocks: per-observation Jacobians exactly as the dense path
(autodiff of the same residual), E/gp reduced over L per point, G/gf summed
over frames by ``index_add_``, and the Schur reduction accumulated into the
[10F, 10F] reduced system in point chunks as Gram products of dense strips:
S = G_diag - sum_chunks B^T B with B_i = L_i^-1 F_i (E_i = L_i L_i^T).

On the card ``index_add_`` sums with atomics, so G, gf and the rhs reduction
are summed in no fixed order and an LM run need not repeat bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from surikatoko_tpu_torch.models.ba import derivs as dv
from surikatoko_tpu_torch.models.ba.derivs import FRAME_VARS, frame_var_mask
from surikatoko_tpu_torch.models.ba.problem import project_f0
from surikatoko_tpu_torch.models.ba.schur import (
    _damp, _fixed_var_identity, add_block_diag_, all_finite,
    preconditioned_cholesky_solve)


class BAProblemSparse(NamedTuple):
    points: torch.Tensor     # [Np, 3]
    cfw_R: torch.Tensor      # [F, 3, 3]
    cfw_t: torch.Tensor      # [F, 3]
    K: torch.Tensor          # [F, 3, 3] f0-scaled
    obs: torch.Tensor        # [Np, L, 2] pixels
    frame_idx: torch.Tensor  # [Np, L] int64 (0 where masked)
    obs_mask: torch.Tensor   # [Np, L] bool
    f0: torch.Tensor

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_frames(self) -> int:
        return self.cfw_R.shape[0]

    @property
    def track_len(self) -> int:
        return self.obs.shape[1]


def dense_obs_to_tracks(obs, obs_mask):
    """Host-side dense-grid -> track-major conversion: numpy (obs [Np,F,2],
    mask [Np,F]) -> (obs_s [Np,L,2], frame_idx [Np,L] int32, track_mask
    [Np,L]) with L = max track length; each row's visible frames first, in
    ascending frame order."""
    obs = np.asarray(obs)
    mask = np.asarray(obs_mask, bool)
    L = max(int(mask.sum(axis=1).max()), 1)
    order = np.argsort(~mask, axis=1, kind="stable")[:, :L]
    counts = mask.sum(axis=1)
    track_mask = np.arange(L)[None, :] < counts[:, None]
    fidx = np.where(track_mask, order, 0).astype(np.int32)
    obs_s = np.take_along_axis(obs, fidx[..., None], axis=1)
    obs_s = np.where(track_mask[..., None], obs_s, 0.0)
    return obs_s, fidx, track_mask


def from_dense(p) -> BAProblemSparse:
    """Convert a dense BAProblem (host-side; for tests/parity)."""
    obs_s, fidx, mask = dense_obs_to_tracks(p.obs.cpu().numpy(),
                                            p.obs_mask.cpu().numpy())
    dev = p.points.device
    return BAProblemSparse(
        points=p.points, cfw_R=p.cfw_R, cfw_t=p.cfw_t, K=p.K,
        obs=torch.as_tensor(obs_s, dtype=p.points.dtype, device=dev),
        frame_idx=torch.as_tensor(fidx, dtype=torch.int64, device=dev),
        obs_mask=torch.as_tensor(mask, device=dev), f0=p.f0)


class SparseBlocks(NamedTuple):
    E: torch.Tensor      # [Np, 3, 3]
    G: torch.Tensor      # [F, 10, 10]
    Fpf: torch.Tensor    # [Np, L, 3, 10]
    gp: torch.Tensor     # [Np, 3]
    gf: torch.Tensor     # [F, 10]


def reproj_error(p: BAProblemSparse) -> torch.Tensor:
    proj = project_f0(p.K[p.frame_idx], p.cfw_R[p.frame_idx],
                      p.cfw_t[p.frame_idx], p.points[:, None, :])
    r = (proj - p.obs / p.f0) * p.obs_mask[..., None].to(p.points.dtype)
    return torch.sum(r * r)


def compute_blocks(p: BAProblemSparse, unity_comp_ind: int = 1,
                   pin_frames: tuple = (),
                   optimize_intrinsics: bool = True) -> SparseBlocks:
    dtype = p.points.dtype
    F = p.n_frames
    per_track = vmap(dv.per_obs_jacobians, in_dims=(0, 0, 0, 0, None))
    r, Jp, Jf = vmap(per_track)(p.K[p.frame_idx], p.cfw_R[p.frame_idx],
                                p.cfw_t[p.frame_idx], p.obs / p.f0, p.points)
    m = p.obs_mask[..., None].to(dtype)
    r = r * m
    Jp = Jp * m[..., None]
    fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics, pin_frames,
                           p.points.device).to(dtype)
    Jf = Jf * m[..., None] * fmask[p.frame_idx][:, :, None, :]

    E = torch.einsum("ilca,ilcb->iab", Jp, Jp)
    unseen = (~torch.any(p.obs_mask, dim=1)).to(dtype)
    E = E + torch.eye(3, dtype=dtype, device=E.device) * unseen[:, None, None]
    gp = torch.einsum("ilca,ilc->ia", Jp, r)
    Fpf = torch.einsum("ilca,ilcb->ilab", Jp, Jf)

    seg = p.frame_idx.reshape(-1)
    Jf2 = Jf.reshape(-1, 2, FRAME_VARS)
    G = Jf.new_zeros(F, FRAME_VARS, FRAME_VARS).index_add_(
        0, seg, torch.einsum("oca,ocb->oab", Jf2, Jf2))
    gf = Jf.new_zeros(F, FRAME_VARS).index_add_(
        0, seg, torch.einsum("oca,oc->oa", Jf2, r.reshape(-1, 2)))
    return SparseBlocks(E=E, G=G, Fpf=Fpf, gp=gp, gf=gf)


def _point_factor(E_d, Fpf, gp):
    """Batched 3x3 Cholesky E_i = L_i L_i^T and the products that ride it:
    (Lch, info, B [Np,3,L,10] = L^-1 F, R [Np,L,10] = B^T L^-1 gp)."""
    Np, L = Fpf.shape[0], Fpf.shape[1]
    Lch, info = torch.linalg.cholesky_ex(E_d)
    Bv = torch.linalg.solve_triangular(
        Lch, Fpf.permute(0, 2, 1, 3).reshape(Np, 3, L * FRAME_VARS),
        upper=False).reshape(Np, 3, L, FRAME_VARS)
    y = torch.linalg.solve_triangular(Lch, gp[:, :, None], upper=False)[..., 0]
    Rv = torch.einsum("ialb,ia->ilb", Bv, y)
    return Lch, info, Bv, Rv


def _reduce_chunk(S, red, Bc, Rc, fc, base: int, W: int) -> None:
    """One point chunk's share of the reduction, in place:
    S[10base:10(base+W)] block += Bm^T Bm and red[base:base+W] += its rhs.

    The Gram strip Bm [3pc, 10W] holds chunk point i's rows B_i at the
    columns of its observing frames, offset by ``base``; it is built by a
    scatter (``index_add_``) rather than the JAX package's one-hot
    product. A slot outside [base, base+W) can only be a masked
    observation, whose rows are exact zeros: it lands in a spare column
    block that is dropped."""
    pc, L = fc.shape
    idx = fc - base
    idx = torch.where((idx >= 0) & (idx < W), idx, W)
    Wp = W + 1
    dev = fc.device
    flat = (torch.arange(pc * 3, device=dev).view(pc, 3, 1, 1) * (Wp * FRAME_VARS)
            + (idx * FRAME_VARS)[:, None, :, None]
            + torch.arange(FRAME_VARS, device=dev).view(1, 1, 1, FRAME_VARS))
    Bm = Bc.new_zeros(pc * 3, Wp * FRAME_VARS)
    Bm.view(-1).index_add_(0, flat.reshape(-1), Bc.reshape(-1))
    Bm = Bm[:, :W * FRAME_VARS]
    lo, hi = FRAME_VARS * base, FRAME_VARS * (base + W)
    S[lo:hi, lo:hi].addmm_(Bm.T, Bm)
    red_w = Rc.new_zeros(Wp, FRAME_VARS).index_add_(
        0, idx.reshape(-1), Rc.reshape(-1, FRAME_VARS))
    red[base:base + W] += red_w[:W]


def _finish(blocks_gf, G, Sg, red, Lch, Fpf, gp, fidx, F):
    """Reduced solve + point back-substitution: (du, dX, info_S)."""
    S2 = add_block_diag_(Sg.neg_(), G)
    rhs = (-(blocks_gf - red)).reshape(F * FRAME_VARS)
    du, info_S = preconditioned_cholesky_solve(S2, rhs)
    du = du.reshape(F, FRAME_VARS)
    # back-substitute through the point Cholesky factor (no batched inverse)
    rhs_pt = gp + torch.einsum("ilab,ilb->ia", Fpf, du[fidx])
    dX = -torch.cholesky_solve(rhs_pt[:, :, None], Lch)[..., 0]
    return du, dX, info_S


def solve_corrections_schur_sparse(
    p: BAProblemSparse, blocks: SparseBlocks, hessian_factor,
    unity_comp_ind: int = 1, optimize_intrinsics: bool = True,
    point_chunk: int = 2048, pin_frames: tuple = (),
):
    """Two-phase Schur solve with full-width Gram strips: per point chunk,
    one [10F, 3pc] @ [3pc, 10F] product accumulates every (l, m)
    frame-pair cross term (``torch.addmm``, cuBLAS on the card). The rhs
    reduction and the point back-substitution ride the same 3x3 Cholesky
    factor. Returns (dX, du, ok); a failed factorization (point or reduced)
    gives ok=False."""
    F = p.n_frames
    fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics, pin_frames,
                           blocks.E.device)
    G = _fixed_var_identity(_damp(blocks.G, hessian_factor), fmask)
    Lch, info_E, Bv, Rv = _point_factor(
        _damp(blocks.E, hessian_factor), blocks.Fpf, blocks.gp)
    Sg = Bv.new_zeros(F * FRAME_VARS, F * FRAME_VARS)
    red = Bv.new_zeros(F, FRAME_VARS)
    for c0 in range(0, Bv.shape[0], point_chunk):
        sl = slice(c0, c0 + point_chunk)
        _reduce_chunk(Sg, red, Bv[sl], Rv[sl], p.frame_idx[sl], 0, F)
    du, dX, info_S = _finish(blocks.gf, G, Sg, red, Lch, blocks.Fpf,
                             blocks.gp, p.frame_idx, F)
    ok = all_finite(du, dX) & (info_S == 0) & torch.all(info_E == 0)
    return dX, du, ok


class BandPlan(NamedTuple):
    """Host-computed plan for the banded Schur reduction (plan_bands)."""
    ext_idx: np.ndarray      # [Npad] int64: sorted point index, or Np (pad)
    band_width: int          # W: frames per banded chunk window
    n_banded_chunks: int     # banded chunks of size point_chunk
    overflow_chunk: int      # chunk size of the full-width overflow loop
    point_chunk: int
    bases: tuple             # first frame of each banded chunk's window


def plan_bands(frame_idx, obs_mask, point_chunk: int, n_frames: int,
               max_band_frac: float = 0.5, max_overflow_frac: float = 0.5,
               band_accept_frac: float = 0.8, min_chunk: int = 256):
    """Host-side banding plan for :func:`solve_corrections_schur_banded`.

    Points sorted by their first observed frame make each point chunk touch
    only a narrow frame band. Points whose own track span exceeds
    ``max_band_frac * n_frames`` (loop-closure / wrap-around tracks) form
    an OVERFLOW group processed with small full-width chunks. Both groups
    are padded to whole chunks via an extended index (pad entries point
    past the last point and read as zeros). When the band is no narrower
    than ``band_accept_frac * n_frames`` the planner halves the chunk (down
    to ``min_chunk``) and retries; it returns None (the caller then uses the
    full-width solver) when fewer than ``1 - max_overflow_frac`` of the
    points are local or the band never gets narrow.

    Each banded chunk's window starts at its first point's first observed
    frame, clamped to [0, F - W]: the port computes these bases here, as
    host ints, where the JAX package computes them on the device per chunk
    from ``frame_idx``/``obs_mask``; slicing by a device scalar would cost
    a host sync per chunk. Pure numpy; call once per observation
    structure."""
    fi = np.asarray(frame_idx)
    m = np.asarray(obs_mask)
    Np = fi.shape[0]
    fmin = np.where(m, fi, n_frames).min(axis=1)
    fmax = np.where(m, fi, -1).max(axis=1)
    fmin = np.where(fmax < 0, 0, fmin)      # unobserved points: trivial band
    fmax = np.maximum(fmax, fmin)
    span = fmax - fmin + 1
    overflow = span > max_band_frac * n_frames
    if overflow.mean() > max_overflow_frac:
        return None
    loc = np.where(~overflow)[0]
    ovf = np.where(overflow)[0]
    if len(loc) == 0:
        return None
    loc = loc[np.argsort(fmin[loc], kind="stable")]
    pc = min(point_chunk, Np)
    while True:
        nb = -(-len(loc) // pc)
        pc_ovf = min(pc, 256) if len(ovf) else pc
        no = -(-len(ovf) // pc_ovf)
        ext = np.full(nb * pc + no * pc_ovf, Np, np.int64)
        ext[:len(loc)] = loc
        ext[nb * pc:nb * pc + len(ovf)] = ovf
        W_raw = 1
        for c in range(nb):
            sel = ext[c * pc:(c + 1) * pc]
            sel = sel[sel < Np]
            W_raw = max(W_raw, int(fmax[sel].max() - fmin[sel].min() + 1))
        # accept on the RAW width, then round up to a multiple of 32 (the
        # JAX package's compile-cache quantization, kept so both packages
        # make the same plan), keeping the exact W where rounding would
        # reach full width
        if W_raw < band_accept_frac * n_frames:
            W = W_raw
            Wq = -(-W // 32) * 32
            if Wq < n_frames:
                W = Wq
            break
        if pc // 2 >= min_chunk:
            pc //= 2            # narrower chunks -> narrower fmin windows
            continue
        return None             # band never narrow enough: full-width wins
    bases = tuple(min(int(fmin[ext[c * pc]]), n_frames - W) for c in range(nb))
    return BandPlan(ext_idx=ext, band_width=W, n_banded_chunks=nb,
                    overflow_chunk=pc_ovf, point_chunk=pc, bases=bases)


def plan_bands_sharded(frame_idx, obs_mask, n_dev: int, point_chunk: int,
                       n_frames: int, **kw):
    """Per-shard banding plans for the point-sharded solver
    (``parallel/sharded_schur``): points are sharded in contiguous blocks
    over the ranks, so each shard gets its own first-frame sort, padded to
    COMMON chunk counts and a common band width W (the JAX package's
    ``shard_map`` needs one static program; here every rank runs the same
    loop). Returns a BandPlan whose ext_idx is [n_dev, Npad] of LOCAL
    indices (sentinel = local Np) and whose ``bases`` holds one tuple of
    banded-chunk window starts per shard (a padding chunk starts at F - W),
    or None when any shard refuses. Pure numpy; the JAX package's plan."""
    fi = np.asarray(frame_idx)
    m = np.asarray(obs_mask)
    Np = fi.shape[0]
    if Np % n_dev:
        raise ValueError(f"{Np} points do not divide by {n_dev} shards")
    Nl = Np // n_dev

    def _plan_all(pc_try):
        plans = []
        for d in range(n_dev):
            pl = plan_bands(fi[d * Nl:(d + 1) * Nl], m[d * Nl:(d + 1) * Nl],
                            pc_try, n_frames, **kw)
            if pl is None:
                return None
            plans.append(pl)
        return plans

    # one chunk size for every shard: if the degenerate-band retry shrank
    # chunks differently per shard, re-plan everyone at the smallest
    pc_try = point_chunk
    while True:
        plans = _plan_all(pc_try)
        if plans is None:
            return None
        pcs = {pl.point_chunk for pl in plans}
        if len(pcs) == 1:
            break
        pc_try = min(pcs)
    pc = plans[0].point_chunk
    pco = min(pl.overflow_chunk for pl in plans)
    W = max(pl.band_width for pl in plans)
    nb = max(pl.n_banded_chunks for pl in plans)
    n_ovf = [int((pl.ext_idx[pl.n_banded_chunks * pl.point_chunk:] < Nl)
                 .sum()) for pl in plans]
    no = max(-(-c // pco) if c else 0 for c in n_ovf)
    Npad = nb * pc + no * pco
    ext = np.full((n_dev, Npad), Nl, np.int64)
    bases = []
    for d, pl in enumerate(plans):
        nbl = pl.n_banded_chunks * pl.point_chunk
        ext[d, :nbl] = pl.ext_idx[:nbl]
        ovl = pl.ext_idx[nbl:]
        ovl = ovl[ovl < Nl]
        ext[d, nb * pc:nb * pc + len(ovl)] = ovl
        fis, ms = fi[d * Nl:(d + 1) * Nl], m[d * Nl:(d + 1) * Nl]
        fmin = np.where(ms, fis, n_frames).min(axis=1)
        fmin = np.where(np.where(ms, fis, -1).max(axis=1) < 0, 0, fmin)
        bases.append(tuple(
            min(int(fmin[ext[d, c * pc]]), n_frames - W)
            if ext[d, c * pc] < Nl else n_frames - W for c in range(nb)))
    return BandPlan(ext_idx=ext, band_width=W, n_banded_chunks=nb,
                    overflow_chunk=pco, point_chunk=pc, bases=tuple(bases))


def shard_plan(plan: BandPlan, rank: int) -> BandPlan:
    """Shard ``rank``'s plan out of :func:`plan_bands_sharded`'s."""
    return plan._replace(ext_idx=plan.ext_idx[rank], bases=plan.bases[rank])


def _banded_reduction(E_d, Fpf, gp, frame_idx, plan: BandPlan, F: int,
                      ext: torch.Tensor):
    """Gram reduction over one point set in banded (extended) order.

    Returns (Sg [10F,10F], red [F,10], Lch, info, Fpf_s, gp_s, fidx_s) where
    the *_s arrays and the per-point Cholesky factor are in extended order
    for back-substitution; ``ext`` (device copy of ``plan.ext_idx``) maps
    extended rows to original point indices (sentinel Np for pads)."""
    L = Fpf.shape[1]
    W, pc, pco = plan.band_width, plan.point_chunk, plan.overflow_chunk
    nb = plan.n_banded_chunks
    Next = ext.shape[0]
    dtype, dev = E_d.dtype, E_d.device

    # gather into extended order; the sentinel row Np reads as zeros
    # (identity for E so its Cholesky stays finite)
    E1 = torch.cat([E_d, torch.eye(3, dtype=dtype, device=dev)[None]])[ext]
    Fpf_s = torch.cat([Fpf, Fpf.new_zeros(1, L, 3, FRAME_VARS)])[ext]
    gp_s = torch.cat([gp, gp.new_zeros(1, 3)])[ext]
    fidx_s = torch.cat([frame_idx, frame_idx.new_zeros(1, L)])[ext]
    Lch, info, Bv, Rv = _point_factor(E1, Fpf_s, gp_s)

    Sg = Bv.new_zeros(F * FRAME_VARS, F * FRAME_VARS)
    red = Bv.new_zeros(F, FRAME_VARS)
    for c, base in enumerate(plan.bases):
        sl = slice(c * pc, (c + 1) * pc)
        _reduce_chunk(Sg, red, Bv[sl], Rv[sl], fidx_s[sl], base, W)
    # overflow group (loop-closure tracks): small full-width chunks
    for c0 in range(nb * pc, Next, pco):
        sl = slice(c0, c0 + pco)
        _reduce_chunk(Sg, red, Bv[sl], Rv[sl], fidx_s[sl], 0, F)
    return Sg, red, Lch, info, Fpf_s, gp_s, fidx_s


def solve_corrections_schur_banded(
    p: BAProblemSparse, blocks: SparseBlocks, hessian_factor,
    plan: BandPlan, ext_idx: torch.Tensor | None = None,
    unity_comp_ind: int = 1, optimize_intrinsics: bool = True,
    pin_frames: tuple = (),
):
    """Banded variant of :func:`solve_corrections_schur_sparse`: points in
    first-observed-frame order (:func:`plan_bands`), so each banded
    chunk's Gram strip is [3pc, 10W] instead of [3pc, 10F] and its product
    lands in one W-frame diagonal window of the reduced system — the exact
    same S at ~(F/W)^2 fewer FLOPs per chunk. ``ext_idx`` is an optional
    device copy of ``plan.ext_idx`` (SparseBundleAdjustment keeps one per plan)."""
    Np = blocks.Fpf.shape[0]
    F = p.n_frames
    dev = blocks.E.device
    if ext_idx is None:
        ext_idx = torch.as_tensor(plan.ext_idx, device=dev)
    fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics, pin_frames,
                           dev)
    G = _fixed_var_identity(_damp(blocks.G, hessian_factor), fmask)
    Sg, red, Lch, info_E, Fpf_s, gp_s, fidx_s = _banded_reduction(
        _damp(blocks.E, hessian_factor), blocks.Fpf, blocks.gp, p.frame_idx,
        plan, F, ext_idx)
    du, dX_s, info_S = _finish(blocks.gf, G, Sg, red, Lch, Fpf_s, gp_s,
                               fidx_s, F)
    # un-permute; writes through pad entries land on the sentinel row
    dX = dX_s.new_zeros(Np + 1, 3).index_copy_(0, ext_idx, dX_s)[:Np]
    ok = all_finite(du, dX) & (info_S == 0) & torch.all(info_E == 0)
    return dX, du, ok


# the frame/point update touches only points/K/cfw_R/cfw_t: the dense one
# applies to the sparse problem as it is
apply_corrections = dv.apply_corrections
