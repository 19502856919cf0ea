"""Distributed Schur-complement BA solve: point blocks sharded over a
process group.

Port of ``surikatoko_tpu/parallel/sharded_schur.py``. The Schur reduction
S = G - sum_i F_i^T E_i^-1 F_i is a sum over points: each rank reduces the
points of its contiguous block (the dense einsum of ``models/ba/schur``, or
the sparse Gram strips of ``models/ba/sparse``, unbanded or banded by
``sparse.plan_bands_sharded``), ONE all_reduce sums the packed reduced
system and rhs, the reduced camera solve is replicated, and each rank
back-substitutes its own points; one all_gather brings every rank the
whole correction (with each block's factorization flag), so the LM on top
keeps one replicated problem. Every rank passes the same full problem and
blocks; n_points must divide by the group's size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from surikatoko_tpu_torch.models.ba import derivs
from surikatoko_tpu_torch.models.ba import sparse as sp
from surikatoko_tpu_torch.models.ba.derivs import FRAME_VARS, frame_var_mask
from surikatoko_tpu_torch.models.ba.schur import (
    _damp, _fixed_var_identity, add_block_diag_, all_finite,
    preconditioned_cholesky_solve)
from surikatoko_tpu_torch.parallel import mesh


class _Points:
    """This rank's contiguous block of the point axis."""

    def __init__(self, group, n_points: int):
        self.group = dist.group.WORLD if group is None else group
        if not mesh.is_member(self.group):
            raise ValueError("this rank is not in the group")
        self.n = dist.get_world_size(self.group)
        if n_points % self.n:
            raise ValueError(f"{n_points} points do not divide by {self.n} "
                             "ranks")
        self.rank = dist.get_rank(self.group)
        self.Nl = n_points // self.n
        self.sl = slice(self.rank * self.Nl, (self.rank + 1) * self.Nl)

    def all_reduce(self, S: torch.Tensor, red: torch.Tensor):
        """(sum S, sum red) over the ranks: one all_reduce of both packed."""
        buf = torch.cat([S.reshape(-1), red.reshape(-1)])
        dist.all_reduce(buf, group=self.group)
        return buf[:S.numel()].view_as(S), buf[S.numel():].view_as(red)

    def gather(self, dX_loc: torch.Tensor, ok_loc: torch.Tensor):
        """(dX [Np,3], every block's ok): one all_gather of the own points'
        corrections with this block's factorization flag packed beside."""
        buf = torch.cat([dX_loc, ok_loc.to(dX_loc.dtype).expand(self.Nl, 1)],
                        dim=1)
        out = buf.new_empty((self.n * self.Nl, 4))
        dist.all_gather_into_tensor(out, buf.contiguous(), group=self.group)
        return out[:, :3], torch.all(out[:, 3] > 0.5)


def make_sharded_schur_solver(n_points: int, n_frames: int, group=None,
                              unity_comp_ind: int = 1):
    """Returns solve(blocks: GNBlocks, hessian_factor) -> (dX, du, ok), the
    dense two-phase solve of ``schur.solve_corrections_schur`` with the
    point reduction sharded over ``group`` (None: the world)."""
    pts = _Points(group, n_points)
    F = n_frames

    def solve(blocks, hessian_factor):
        fmask = frame_var_mask(F, unity_comp_ind, True, (), blocks.E.device)
        G = _fixed_var_identity(_damp(blocks.G, hessian_factor), fmask)
        Fpf, gp = blocks.Fpf[pts.sl], blocks.gp[pts.sl]
        Einv, info_E = torch.linalg.inv_ex(_damp(blocks.E[pts.sl],
                                                 hessian_factor))
        C = torch.einsum("iab,ifbc->ifac", Einv, Fpf)
        S_part = -torch.einsum("ifab,igac->fbgc", Fpf, C).reshape(
            F * FRAME_VARS, F * FRAME_VARS)
        w = torch.einsum("iab,ib->ia", Einv, gp)
        red_part = torch.einsum("ifab,ia->fb", Fpf, w)
        S, red = pts.all_reduce(S_part, red_part)
        du, info_S = preconditioned_cholesky_solve(
            add_block_diag_(S, G), (-(blocks.gf - red)).reshape(-1))
        du = du.reshape(F, FRAME_VARS)
        dX_loc = -torch.einsum("iab,ib->ia", Einv,
                               gp + torch.einsum("ifab,fb->ia", Fpf, du))
        dX, ok_E = pts.gather(dX_loc, torch.all(info_E == 0))
        return dX, du, all_finite(du, dX) & (info_S == 0) & ok_E

    return solve


def make_sharded_sparse_schur_solver(n_points: int, n_frames: int,
                                     track_len: int, group=None,
                                     unity_comp_ind: int = 1,
                                     optimize_intrinsics: bool = True,
                                     point_chunk: int = 2048,
                                     pin_frames: tuple = (),
                                     band_plan=None):
    """Distributed sparse Schur solve: each rank accumulates its points'
    Gram strips (``sparse._reduce_chunk``), one all_reduce of the [10F,10F]
    system and rhs, the replicated preconditioned Cholesky solve, local
    back-substitution. ``band_plan`` (``sparse.plan_bands_sharded``)
    switches each rank to the banded reduction of its own first-frame
    order. Returns solve(p: BAProblemSparse, blocks: SparseBlocks,
    hessian_factor) -> (dX, du, ok)."""
    pts = _Points(group, n_points)
    F = n_frames
    plan = None if band_plan is None else sp.shard_plan(band_plan, pts.rank)
    ext_dev = {}

    def solve(p, blocks, hessian_factor):
        dev = blocks.E.device
        fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics,
                               pin_frames, dev)
        G = _fixed_var_identity(_damp(blocks.G, hessian_factor), fmask)
        E_d = _damp(blocks.E[pts.sl], hessian_factor)
        Fpf, gp = blocks.Fpf[pts.sl], blocks.gp[pts.sl]
        fidx = p.frame_idx[pts.sl]
        if plan is None:
            Lch, info_E, Bv, Rv = sp._point_factor(E_d, Fpf, gp)
            Sg = Bv.new_zeros(F * FRAME_VARS, F * FRAME_VARS)
            red = Bv.new_zeros(F, FRAME_VARS)
            for c0 in range(0, pts.Nl, point_chunk):
                sl = slice(c0, c0 + point_chunk)
                sp._reduce_chunk(Sg, red, Bv[sl], Rv[sl], fidx[sl], 0, F)
        else:
            if dev not in ext_dev:
                ext_dev[dev] = torch.as_tensor(plan.ext_idx, device=dev)
            ext = ext_dev[dev]
            Sg, red, Lch, info_E, Fpf, gp, fidx = sp._banded_reduction(
                E_d, Fpf, gp, fidx, plan, F, ext)
        Sg, red = pts.all_reduce(Sg, red)
        du, dX_loc, info_S = sp._finish(blocks.gf, G, Sg, red, Lch, Fpf, gp,
                                        fidx, F)
        if plan is not None:
            # un-permute; writes through pad entries land on the sentinel
            dX_loc = dX_loc.new_zeros(pts.Nl + 1, 3).index_copy_(
                0, ext, dX_loc)[:pts.Nl]
        dX, ok_E = pts.gather(dX_loc, torch.all(info_E == 0))
        return dX, du, all_finite(du, dX) & (info_S == 0) & ok_E

    return solve


def make_sharded_ba_step(n_points: int, n_frames: int, group=None,
                         unity_comp_ind: int = 1):
    """One distributed Gauss-Newton / LM trial step: the dense derivative
    blocks, the sharded Schur solve, the correction applied. Returns
    step(p: BAProblem, hessian_factor) -> (p_new, ok)."""
    solver = make_sharded_schur_solver(n_points, n_frames, group,
                                       unity_comp_ind)

    def step(p, hessian_factor):
        blocks = derivs.compute_blocks(p, unity_comp_ind=unity_comp_ind)
        dX, du, ok = solver(blocks, hessian_factor)
        return derivs.apply_corrections(p, dX, du), ok

    return step


def run_sparse_ba(p, term_crit, group=None, **ba_kw) -> dict:
    """``SparseBundleAdjustment(group=group, **ba_kw).compute(p, term_crit)``
    as the rank body of a distributed sparse BA: its ok, problem, stop
    reason, iterations and trials, and whether the sharded band plan
    engaged."""
    from surikatoko_tpu_torch.models.ba import SparseBundleAdjustment
    ba = SparseBundleAdjustment(group=group, **ba_kw)
    ok, p_opt = ba.compute(p, term_crit)
    return {"ok": ok, "problem": p_opt, "stop_reason": ba.stop_reason,
            "iterations": ba.iterations, "trials": ba.trials,
            "banded": ba._mesh_band_plan is not None,
            "err": sp.reproj_error(p_opt)}
