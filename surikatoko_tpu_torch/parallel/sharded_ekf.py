"""Landmark-sharded EKF: the stacked update and the fused frame step over a
process group.

Port of ``surikatoko_tpu/parallel/sharded_ekf.py``. Layout as in JAX: x and
the 13 camera rows of P (``P_cam`` [13, D]) are replicated; each of the n
ranks holds the covariance rows of its L = K / n landmark slots (``P_rows``
[6L, D], rows 13 + 6 L rank ...). Slots are laid out rank-major, so
gathered per-slot data is in slot order and the first-free order of a
recruit equals the single-device one. Per frame:

  local   h, H and A_k = H_k P for the own slots (camera stripe + own rows)
  gather  ONE all_gather of a packed buffer: H blocks, A rows, residuals,
          the own diagonal of P (the keep mask) and, where used, the
          drop / free masks
  repl    S = A H^T + R = C C^T, the whitened gain B = C^-1 A, x update,
          keep mask, camera epilogue (the single-device fused step's code)
  local   the downdate of the own rows and of the camera rows through
          kernel B2's row-slab form (``ops/covariance.symmetric_downdate_
          rows``): each element bit for bit what the full B2 call of the
          single-device step writes there, so the assembled P is exactly
          symmetric with no repair pass, as JAX's Gram form gives on its
          mesh; the camera-column block of the own rows is the transpose of
          the replicated camera rows.

A frame loop keeps each rank's rows local; the step functions below take
and return the full P (every rank passes the same), gathering the rows once
at the end, for callers and tests that want the whole matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from surikatoko_tpu_torch.models.monoslam import fused_step as fused_mod
from surikatoko_tpu_torch.models.monoslam import measure
from surikatoko_tpu_torch.models.monoslam import update as update_mod
from surikatoko_tpu_torch.models.monoslam.state import (
    CAM_STATE_COMPS,
    MonoSlamParams,
)
from surikatoko_tpu_torch.ops.covariance import symmetric_downdate_rows
from surikatoko_tpu_torch.parallel import mesh

_N = CAM_STATE_COMPS


class Shard(NamedTuple):
    """This rank's block of the landmark axis."""
    group: object
    n: int          # ranks
    rank: int
    L: int          # slots a rank
    col0: int       # first own row (and column) of P: 13 + 6 L rank


def shard_of(group, capacity: int) -> Shard:
    """The rank's shard of ``capacity`` slots over ``group`` (None: the
    world); capacity must divide by the group's size."""
    group = dist.group.WORLD if group is None else group
    if not mesh.is_member(group):
        raise ValueError("this rank is not in the group")
    n = dist.get_world_size(group)
    if capacity % n:
        raise ValueError(f"capacity {capacity} does not divide by {n} ranks")
    rank = dist.get_rank(group)
    L = capacity // n
    return Shard(group, n, rank, L, _N + 6 * L * rank)


def all_gather_rows(t: torch.Tensor, sh: Shard) -> torch.Tensor:
    """[n * t.shape[0], ...]: every rank's ``t`` stacked in rank order."""
    out = t.new_empty((sh.n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=sh.group)
    return out


def gather_packed(parts: list, sh: Shard) -> list:
    """One all_gather of several per-slot tensors [L, ...] of one dtype,
    packed into one buffer; returns each as [n L, ...] in slot order."""
    L = parts[0].shape[0]
    flat = all_gather_rows(torch.cat([p.reshape(L, -1) for p in parts], 1), sh)
    outs, o = [], 0
    for p in parts:
        w = p[0].numel()
        outs.append(flat[:, o:o + w].reshape(-1, *p.shape[1:]))
        o += w
    return outs


def local_products(params: MonoSlamParams, x: torch.Tensor,
                   P_cam: torch.Tensor, P_rows: torch.Tensor, sh: Shard):
    """(h [L,2], Hcam [L,2,13], Hlm [L,2,6], A [L,2,D] = H P, row_ok [L]) of
    the own slots, unmasked; a slot whose projection or Jacobian is not
    finite has exact zero rows and row_ok False (0 * NaN would poison the
    update)."""
    L, D = sh.L, x.shape[0]
    lms = x[sh.col0:sh.col0 + 6 * L].reshape(L, 6)
    h, Hcam, Hlm = measure.batched_jacobians(params, x[:_N], lms)
    ok = (torch.isfinite(h).all(dim=-1)
          & torch.isfinite(Hcam.reshape(L, -1)).all(dim=-1)
          & torch.isfinite(Hlm.reshape(L, -1)).all(dim=-1))
    h = torch.where(ok[:, None], h, 0.0)
    Hcam = torch.where(ok[:, None, None], Hcam, 0.0)
    Hlm = torch.where(ok[:, None, None], Hlm, 0.0)
    A = (torch.einsum("kij,jd->kid", Hcam, P_cam)
         + torch.bmm(Hlm, P_rows.reshape(L, 6, D)))
    return h, Hcam, Hlm, A, ok


def own_diagonal(P_rows: torch.Tensor, sh: Shard) -> torch.Tensor:
    """[L, 6]: the own rows' diagonal entries of P."""
    r = torch.arange(6 * sh.L, device=P_rows.device)
    return P_rows[r, sh.col0 + r].reshape(sh.L, 6)


def _put_(T: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
          vals: torch.Tensor, dim: int) -> None:
    """In place: T[idx[e]] = vals[e] (``dim`` 0, rows) or T[:, idx[e]] =
    vals[e] (``dim`` 1, columns) for every valid e; shapes stay fixed and
    nothing waits for the card: an invalid entry repeats the first valid
    one's write, and with none valid every write puts back what is there."""
    n = idx.shape[0]
    any_v = valid.any()
    src = torch.where(valid, torch.arange(n, device=idx.device),
                      torch.argmax(valid.to(torch.int32)))
    tgt = torch.where(any_v, idx[src], 0)
    if dim == 0:
        T[tgt] = torch.where(any_v, vals[src], T[tgt])
    else:
        T[:, tgt] = torch.where(any_v, vals[src].T, T[:, tgt])


class Gathered(NamedTuple):
    """The frame's replicated inputs after the one all_gather."""
    Hcam: torch.Tensor     # [K,2,13] masked
    Hlm: torch.Tensor      # [K,2,6] masked
    A: torch.Tensor        # [2K,D] masked
    resid: torch.Tensor    # [K,2] masked
    diag: torch.Tensor     # [D] diagonal of P
    drop: torch.Tensor | None   # [K] bool, deactivated slots
    free: torch.Tensor | None   # [K] bool, free slots (recruit)


def frame_parts(params, x, P_cam, P_rows, sh, obs_loc, mask_loc,
                precomputed=None):
    """The own slots' share of the frame's gather: [Hcam, Hlm, A, resid,
    diag], masked by ``mask_loc`` (and by the rows' finiteness).
    ``precomputed`` = (h, Hcam, Hlm, A) unmasked, as :func:`local_products`
    gives them (the imageseq loop builds them for its search ellipse)."""
    if precomputed is None:
        h, Hcam, Hlm, A, ok = local_products(params, x, P_cam, P_rows, sh)
    else:
        (h, Hcam, Hlm, A), ok = precomputed, None
    use = mask_loc if ok is None else mask_loc & ok
    m = use.to(x.dtype)
    parts = [Hcam * m[:, None, None], Hlm * m[:, None, None],
             A * m[:, None, None],
             torch.where(use[:, None], obs_loc - h, 0.0),
             own_diagonal(P_rows, sh)]
    return parts


def unpack(gathered: list, P_cam: torch.Tensor) -> Gathered:
    """:class:`Gathered` from ``gather_packed``'s output of
    :func:`frame_parts`'s parts (drop and free left None: a caller that
    packs them sets them)."""
    Hcam, Hlm, A, r, diag_lm = gathered[:5]
    diag = torch.cat([torch.diagonal(P_cam[:, :_N]), diag_lm.reshape(-1)])
    return Gathered(Hcam, Hlm, A.reshape(-1, A.shape[-1]), r, diag, None,
                    None)


def _gain(params: MonoSlamParams, x: torch.Tensor, g: Gathered):
    """(x1, B [2K,D], chol_info) of the stacked update from the gathered
    frame: the single-device step's innovation, Cholesky and one triangular
    solve."""
    K2 = g.A.shape[0]
    r_var = params.measurm_noise_var.to(x.dtype)
    S2 = update_mod.aht_auto(g.A, g.Hcam, g.Hlm) + r_var * torch.eye(
        K2, dtype=x.dtype, device=x.device)
    C, info = torch.linalg.cholesky_ex(S2)
    By = torch.linalg.solve_triangular(
        C, torch.cat([g.A, g.resid.reshape(K2, 1)], dim=1), upper=False)
    B, y = By[:, :-1], By[:, -1]
    return x + B.T @ y, B.contiguous(), info


def stacked_update_local(params: MonoSlamParams, sh: Shard, x, P_cam, P_rows,
                         obs_loc, mask_loc):
    """The stacked update on this rank's rows: (x' [D] replicated, P_cam'
    [13,D] replicated, P_rows' [6L,D] own, resid [K,2] replicated,
    chol_info)."""
    parts = frame_parts(params, x, P_cam, P_rows, sh, obs_loc, mask_loc)
    g = unpack(gather_packed(parts, sh), P_cam)
    x_new, B, info = _gain(params, x, g)
    # P' = P - B^T B: the camera rows and the own rows of B2's output
    return (x_new, symmetric_downdate_rows(P_cam.contiguous(), B, None, 0),
            symmetric_downdate_rows(P_rows, B, None, sh.col0), g.resid, info)


def fused_step_local(params: MonoSlamParams, sh: Shard, x, P_cam, P_rows,
                     g: Gathered, recruit=None):
    """The fused frame (update + health + delete + (recruit) + predict as
    one congruence) on this rank's rows, from the frame's gathered inputs
    ``g`` (``g.drop`` folds the delete-unobserved policy in, as the
    single-device ``deactivate_mask``).

    ``recruit`` = (new_pix [M,2], new_valid [M], rho0 or None), replicated,
    with ``g.free`` the gathered free mask: the recruit math is the
    single-device one on replicated inputs (a new slot's rows come from the
    replicated camera stripe and gain); the owner rank writes the new rows,
    every rank the new columns of its own rows.

    Returns (x_next, P_cam', P_rows', x1, chol_info[, slots [M]])."""
    dtype, dev = x.dtype, x.device
    K = g.Hcam.shape[0]
    x1, B, info = _gain(params, x, g)
    keep = ((g.diag - torch.sum(B * B, dim=0)) >= 0).to(dtype)
    if g.drop is not None:
        lm_zero = torch.repeat_interleave(g.drop, 6)
        keep = torch.cat([keep[:_N], keep[_N:] * (~lm_zero).to(dtype)])
        zero = torch.cat([torch.zeros(_N, dtype=torch.bool, device=dev),
                          lm_zero])
        x1 = torch.where(zero, 0.0, x1)
    epi = fused_mod.camera_epilogue(params, x1, K)

    # camera rows: the single-device camera congruence on B2's rows 0-12
    D1_cam = symmetric_downdate_rows(P_cam.contiguous(), B, keep, 0)
    Q = params.process_noise_cov.to(dtype)
    top = epi.Cp @ D1_cam
    corner = top[:, :_N] @ epi.Cp.T + epi.G @ Q @ epi.G.T
    top[:, :_N] = 0.5 * (corner + corner.T)
    P_cam_new = top
    # own rows: B2's rows, their camera columns the camera rows' transpose
    R6 = P_rows.shape[0]
    P_rows_new = symmetric_downdate_rows(P_rows, B, keep, sh.col0)
    P_rows_new[:, :_N] = P_cam_new[:, sh.col0:sh.col0 + R6].T
    if params.covar_diag_inflation is not None:
        infl = params.covar_diag_inflation.to(dtype)
        dc = torch.diagonal(P_cam_new[:, :_N])
        dc.add_(torch.where(dc > 0, infl * keep[:_N], 0.0))
        r = torch.arange(R6, device=dev)
        dl = P_rows_new[r, sh.col0 + r]
        P_rows_new[r, sh.col0 + r] = dl + torch.where(
            dl > 0, infl * keep[sh.col0:sh.col0 + R6], 0.0)
    if recruit is None:
        return epi.x_next, P_cam_new, P_rows_new, x1, info

    new_pix, new_valid, rho0 = recruit
    M = new_pix.shape[0]
    kc = keep[:_N]
    rows7 = (P_cam[:7, :] - B[:, :7].T @ B) * (kc[:7, None] * keep[None, :])
    rows7[3:7, :] = epi.Jq @ rows7[3:7, :]
    rows7[:, 3:7] = rows7[:, 3:7] @ epi.Jq.T
    P77 = 0.5 * (rows7[:, :7] + rows7[:, :7].T)
    y_m, Rt, slots, valid, idx, idx_safe, v6 = fused_mod.recruit_rows(
        params, epi.x2[:7], rows7, P77, g.free, new_pix, new_valid, rho0,
        epi.F)
    # rows then columns, as the single-device _write_sym_stripes
    _put_(P_cam_new, idx, v6, Rt[:, :_N], 1)
    own = v6 & (idx >= sh.col0) & (idx < sh.col0 + R6)
    _put_(P_rows_new, idx - sh.col0, own, Rt, 0)
    _put_(P_rows_new, idx, v6, Rt[:, sh.col0:sh.col0 + R6], 1)
    x_next = fused_mod.scatter_drop(epi.x_next, idx_safe, y_m.reshape(6 * M))
    return x_next, P_cam_new, P_rows_new, x1, info, slots


def split_rows(P: torch.Tensor, sh: Shard):
    """(P_cam, P_rows) of this rank from the full P."""
    return P[:_N].contiguous(), P[sh.col0:sh.col0 + 6 * sh.L].contiguous()


def _slots(t: torch.Tensor, sh: Shard) -> torch.Tensor:
    """The own slots' entries of a per-slot tensor [K, ...]."""
    return t[sh.rank * sh.L:(sh.rank + 1) * sh.L]


def assemble(P_cam: torch.Tensor, P_rows: torch.Tensor, sh: Shard
             ) -> torch.Tensor:
    """The full P [D,D] on every rank: one all_gather of the own rows."""
    return torch.cat([P_cam, all_gather_rows(P_rows, sh)])


def make_sharded_fused_step(params: MonoSlamParams, capacity: int,
                            group=None):
    """Landmark-sharded fused frame step over ``group`` (None: the world):
    the sharded counterpart of ``fused_step.fused_update_health_predict``.
    Returns step(x, P, obs, obs_mask) -> (x_next, P_next, resid [K,2], x1,
    chol_info), every input and output the full, replicated one (each rank
    passes the same x, P, obs and mask and gets the same results)."""
    sh = shard_of(group, capacity)

    def step(x, P, obs, obs_mask):
        P_cam, P_rows = split_rows(P, sh)
        parts = frame_parts(params, x, P_cam, P_rows, sh,
                                  _slots(obs, sh), _slots(obs_mask, sh))
        g = unpack(gather_packed(parts, sh), P_cam)
        x_next, P_cam2, P_rows2, x1, info = fused_step_local(
            params, sh, x, P_cam, P_rows, g)
        return x_next, assemble(P_cam2, P_rows2, sh), g.resid, x1, info

    return step


def make_sharded_fused_loop(params: MonoSlamParams, capacity: int,
                            group=None):
    """Frames of the sharded fused step with each rank's rows kept local
    between them (the closed-loop form). Returns loop(x, P, obs [T,K,2],
    obs_mask [K] or [T,K]) -> (x, P, costs [T]) with P gathered once at the
    end and costs the frames' sums of squared masked residuals."""
    sh = shard_of(group, capacity)
    own = slice(sh.rank * sh.L, (sh.rank + 1) * sh.L)

    def loop(x, P, obs, obs_mask):
        P_cam, P_rows = split_rows(P, sh)
        costs = []
        for t in range(obs.shape[0]):
            mask = obs_mask if obs_mask.dim() == 1 else obs_mask[t]
            parts = frame_parts(params, x, P_cam, P_rows, sh,
                                      obs[t][own], mask[own])
            g = unpack(gather_packed(parts, sh), P_cam)
            x, P_cam, P_rows, _, _ = fused_step_local(params, sh, x, P_cam,
                                                      P_rows, g)
            costs.append(torch.sum(g.resid * g.resid))
        return x, assemble(P_cam, P_rows, sh), torch.stack(costs)

    return loop


def make_sharded_fused_recruit_step(params: MonoSlamParams, capacity: int,
                                    group=None):
    """The sharded counterpart of ``fused_step.
    fused_update_health_recruit_predict`` (the recruit splice the sharded
    imageseq loop runs) over ``group``. Returns step(x, P, obs, obs_mask,
    new_pix, new_valid, free_mask, deactivate_mask=None, rho0=None) ->
    (x_next, P_next, resid, x1, slots, chol_info), full and replicated; the
    free and drop masks ride the frame's one gather."""
    sh = shard_of(group, capacity)

    def step(x, P, obs, obs_mask, new_pix, new_valid, free_mask,
             deactivate_mask=None, rho0=None):
        P_cam, P_rows = split_rows(P, sh)
        parts = frame_parts(params, x, P_cam, P_rows, sh,
                                  _slots(obs, sh), _slots(obs_mask, sh))
        drop = (torch.zeros_like(free_mask) if deactivate_mask is None
                else deactivate_mask)
        masks = torch.stack([_slots(drop, sh), _slots(free_mask, sh)], 1)
        gathered = gather_packed(parts + [masks.to(x.dtype)], sh)
        flags = gathered[5] > 0.5
        g = unpack(gathered[:5], P_cam)._replace(
            drop=None if deactivate_mask is None else flags[:, 0],
            free=flags[:, 1])
        x_next, P_cam2, P_rows2, x1, info, slots = fused_step_local(
            params, sh, x, P_cam, P_rows, g,
            recruit=(new_pix, new_valid, rho0))
        return (x_next, assemble(P_cam2, P_rows2, sh), g.resid, x1, slots,
                info)

    return step


def make_sharded_stacked_update(params: MonoSlamParams, capacity: int,
                                group=None):
    """Landmark-sharded stacked update over ``group`` (None: the world):
    the sharded counterpart of ``update.stacked_update``. Returns update(x,
    P, obs, obs_mask) -> (x', P', resid [K,2], chol_info), full and
    replicated like :func:`make_sharded_fused_step`'s."""
    sh = shard_of(group, capacity)

    def update(x, P, obs, obs_mask):
        P_cam, P_rows = split_rows(P, sh)
        x_new, P_cam2, P_rows2, resid, info = stacked_update_local(
            params, sh, x, P_cam, P_rows, _slots(obs, sh),
            _slots(obs_mask, sh))
        return x_new, assemble(P_cam2, P_rows2, sh), resid, info

    return update
