"""Fused EKF frame step: stacked update + variance clamp + landmark deletion
+ quaternion renormalization (+ recruitment) + kinematic predict as ONE
covariance congruence.

Port of ``surikatoko_tpu/models/monoslam/fused_step.py``. With V =
blockdiag(Cp, I) diag(keep) the whole frame is

    P+ = V (P - B^T B) V^T + G Q G^T

written as one masked downdate D1 = P*kk^T - (B diag k)^T (B diag k) (the
symmetric downdate kernel of ``ops/covariance``, which applies the mask in
its epilogue and writes each lower-triangle value to both halves) plus
overwrites of the 13 camera rows and columns, the column stripe copied from
the row stripe's transpose, so that P stays exactly symmetric (reference
davison-mono-slam.cpp :1114, :1739, :1652, :1713, :639; recruitment
:923 -> :1812 -> :2597).

Differences from the JAX package, by design:
* without ``precomputed``, a masked slot whose projection is not finite
  adds exact zeros (``update._masked_jacobians``), where JAX's NaN spreads
  through the whole update (ROADMAP C.2);
* the innovation Cholesky is ``torch.linalg.cholesky_ex`` (no host sync) and
  its ``info`` is returned as the last output of the fused steps, where JAX
  would carry a NaN factor silently;
* JAX's ``mode="drop"`` scatters (index D means "skip") have no torch
  counterpart: small vectors get one scratch slot (:func:`scatter_drop`),
  and the [D,D] covariance rows are written by :func:`_write_sym_stripes`,
  which points skipped entries at a valid entry's write of the same values,
  so shapes stay fixed and no index is filtered on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from surikatoko_tpu_torch.models.monoslam import landmarks as lm_mod
from surikatoko_tpu_torch.models.monoslam import health as health_mod
from surikatoko_tpu_torch.models.monoslam import predict as predict_mod
from surikatoko_tpu_torch.models.monoslam import update as update_mod
from surikatoko_tpu_torch.models.monoslam.state import (
    CAM_STATE_COMPS,
    REPRES_SPHERICAL,
    MonoSlamParams,
)
from surikatoko_tpu_torch.ops.covariance import symmetric_downdate
from surikatoko_tpu_torch.utils.profiling import span

_N = CAM_STATE_COMPS


def scatter_drop(t: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Copy of ``t`` with ``t[idx] = vals`` along dim 0, where an index equal
    to ``len(t)`` writes nothing (JAX ``.at[idx].set(vals, mode="drop")``).
    Skipped writes land in one scratch slot that is cut off again."""
    out = torch.cat([t, t[:1]])
    out[idx] = vals
    return out[:-1]


def _write_sym_stripes(P: torch.Tensor, idx: torch.Tensor,
                       valid: torch.Tensor, rows: torch.Tensor) -> None:
    """In place: P[idx[e], :] = rows[e] and P[:, idx[e]] = rows[e] for every
    valid entry e; invalid entries write nothing. Each invalid entry is
    pointed at the first valid entry and repeats its write (same index, same
    values, so the duplicate is harmless); with no valid entry every write
    puts back the values already there."""
    n = idx.shape[0]
    any_v = valid.any()
    first = torch.argmax(valid.to(torch.int32))
    src = torch.where(valid, torch.arange(n, device=idx.device), first)
    tgt = idx[src]
    P[tgt, :] = torch.where(any_v, rows[src], P[tgt, :])
    P[:, tgt] = torch.where(any_v, rows[src].T, P[:, tgt])


class EpilogueResult(NamedTuple):
    x_next: torch.Tensor   # [D] predicted state for the next frame
    Cp: torch.Tensor       # [13,13] predict+renorm camera block
    G: torch.Tensor        # [13,6] process-noise injector
    x2: torch.Tensor       # [D] post-health, post-renorm, pre-predict state
    Jq: torch.Tensor       # [4,4] quaternion-renorm Jacobian
    F: torch.Tensor        # [13,13] kinematic transition Jacobian


def camera_epilogue(params: MonoSlamParams, x1: torch.Tensor, Kcap: int
                    ) -> EpilogueResult:
    """Negative-inverse-depth substitution, quaternion renorm with its
    Jacobian folded in, and the kinematic predict of the camera."""
    with span("frame.predict"):
        if params.sal_pnt_repres == REPRES_SPHERICAL:
            x1, _ = health_mod.substitute_negative_inv_rho(
                x1, params.sal_pnt_negative_inv_rho_substitute, Kcap)
        return EpilogueResult(
            *predict_mod.renormalize_and_transition(params, x1))


def fused_update_health_predict(
    params: MonoSlamParams, x: torch.Tensor, P: torch.Tensor,
    obs: torch.Tensor, obs_mask: torch.Tensor,
    *, precomputed: tuple | None = None,
    deactivate_mask: torch.Tensor | None = None,
):
    """One frame of the closed loop with update_impl=1.

    Returns (x_next, P_next, resid [K,2], x_post_update [D], chol_info):
    (x_next, P_next) are predicted for the next frame; ``chol_info`` is the
    innovation Cholesky's info (0 = factorized). ``precomputed`` optionally
    carries (h, A_un = H P, T_un = H P H^T), unmasked, at this ``x``."""
    Kcap = obs_mask.shape[0]
    x1, B, keep, resid, info = _fused_update_core(
        params, x, P, obs, obs_mask, precomputed, deactivate_mask)
    x_next, Cp, G = camera_epilogue(params, x1, Kcap)[:3]
    P_next = _fused_covariance_predict(params, P, B, keep, Cp, G)
    return x_next, P_next, resid, x1, info


def _fused_update_core(params, x, P, obs, obs_mask, precomputed,
                       deactivate_mask):
    """Stacked update + keep-mask head of the fused step. Returns (x1, B
    whitened gain precursor [2K,D], keep [D], resid [K,2], chol_info)."""
    with span("frame.update"):
        dtype, dev = x.dtype, x.device
        Kcap = obs_mask.shape[0]
        r_var = params.measurm_noise_var.to(dtype)
        eye2k = torch.eye(2 * Kcap, dtype=dtype, device=dev)
        if precomputed is None:
            h, Hcam, Hlm, use = update_mod._masked_jacobians(params, x,
                                                             obs_mask)
            resid = torch.where(use[:, None], obs - h, 0.0)
            A2 = update_mod.hp_auto(Hcam, Hlm, P)
            S2 = update_mod.aht_auto(A2, Hcam, Hlm) + r_var * eye2k
        else:
            h, A_un, T_un = precomputed
            resid = (obs - h) * obs_mask[:, None].to(dtype)
            m2 = torch.repeat_interleave(obs_mask, 2).to(dtype)
            A2 = A_un * m2[:, None]
            S2 = T_un * (m2[:, None] * m2[None, :]) + r_var * eye2k
        C, info = torch.linalg.cholesky_ex(S2)
        # one triangular solve for the whitened gain and the whitened residual
        By = torch.linalg.solve_triangular(
            C, torch.cat([A2, resid.reshape(2 * Kcap, 1)], dim=1), upper=False)
        B, y = By[:, :-1], By[:, -1]
        x1 = x + B.T @ y

        keep = ((torch.diagonal(P) - torch.sum(B * B, dim=0)) >= 0).to(dtype)
        if deactivate_mask is not None:
            lm_zero = torch.repeat_interleave(deactivate_mask, 6)
            keep = torch.cat([keep[:_N], keep[_N:] * (~lm_zero).to(dtype)])
            zero = torch.cat([torch.zeros(_N, dtype=torch.bool, device=dev),
                              lm_zero])
            x1 = torch.where(zero, 0.0, x1)
        return x1, B, keep, resid, info


def _fused_covariance_predict(params, P, B, keep, Cp, G):
    """P+ = V P V^T - (B V^T)^T (B V^T) + G Q G^T as one masked symmetric
    downdate plus camera-stripe overwrites, then the optional diagonal
    inflation of live variances."""
    with span("frame.predict"):
        D1 = symmetric_downdate(P, B.contiguous(), keep)
        predict_mod.camera_congruence_(params, D1, Cp, G)
        if params.covar_diag_inflation is not None:
            infl = params.covar_diag_inflation.to(P.dtype)
            dg = torch.diagonal(D1)
            dg.add_(torch.where(dg > 0, infl * keep, 0.0))
        return D1


def _clipped_median_or_prior(vals: torch.Tensor, ok: torch.Tensor,
                             prior: torch.Tensor) -> torch.Tensor:
    """Masked lower median over the last axis, clipped to [0.05, 20]x the
    prior, falling back to the prior when nothing is usable."""
    masked = torch.where(ok, vals, torch.inf)
    srt = torch.sort(masked, dim=-1).values
    n_ok = ok.sum(dim=-1)
    mid = torch.clamp((n_ok - 1) // 2, min=0)
    med = torch.take_along_dim(srt, mid[..., None], dim=-1)[..., 0]
    good = (n_ok > 0) & torch.isfinite(med)
    return torch.where(good, torch.clamp(med, 0.05 * prior, 20.0 * prior),
                       prior)


def median_tracked_inv_depth(params: MonoSlamParams, x: torch.Tensor,
                             active: torch.Tensor, Kcap: int) -> torch.Tensor:
    """Global (lower) median inverse depth of the active landmarks, clipped
    around the configured prior (spherical only; XYZ gets the prior)."""
    prior = params.sal_pnt_init_inv_dist.to(x.dtype)
    if params.sal_pnt_repres != REPRES_SPHERICAL:
        return prior
    rho = x[_N:].reshape(Kcap, 6)[:, 5]
    usable = active & (rho > 0) & torch.isfinite(rho)
    return _clipped_median_or_prior(rho, usable, prior)


def local_tracked_inv_depth(params: MonoSlamParams, x: torch.Tensor,
                            active: torch.Tensor, Kcap: int,
                            cand_pix: torch.Tensor, slot_pix: torch.Tensor,
                            k_nearest: int = 8) -> torch.Tensor:
    """Per-candidate median inverse depth of its ``k_nearest`` nearest active
    landmarks in pixel space, clipped around the prior, with per-candidate
    fallback to the prior. Only the usable neighbours enter the median, so
    the order ``topk`` gives tied (masked) entries does not matter."""
    prior = params.sal_pnt_init_inv_dist.to(x.dtype)
    M = cand_pix.shape[0]
    if params.sal_pnt_repres != REPRES_SPHERICAL:
        return prior.expand(M)
    rho = x[_N:].reshape(Kcap, 6)[:, 5]
    usable = active & (rho > 0) & torch.isfinite(rho)
    d2 = torch.sum((cand_pix[:, None, :].to(x.dtype)
                    - slot_pix[None, :, :].to(x.dtype)) ** 2, dim=-1)
    d2 = torch.where(usable[None, :], d2, torch.inf)
    nn = torch.topk(-d2, min(k_nearest, Kcap), dim=-1).indices
    return _clipped_median_or_prior(rho[nn], usable[nn], prior)


def assign_free_slots(free_mask: torch.Tensor, new_valid: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The j-th valid candidate claims the j-th free slot (lowest index
    first). Returns (slots [M] int32, -1 where not assigned; valid [M])."""
    Kcap = free_mask.shape[0]
    order = torch.argsort((~free_mask).to(torch.int32), stable=True)
    n_free = free_mask.sum()
    rank = torch.cumsum(new_valid.to(torch.int32), dim=0) - 1
    valid = new_valid & (rank < n_free)
    slots_raw = order[torch.clamp(rank, 0, Kcap - 1)].to(torch.int32)
    return torch.where(valid, slots_raw, -1), valid


def recruit_rows(params: MonoSlamParams, cam_pq: torch.Tensor,
                 rows7: torch.Tensor, P77: torch.Tensor,
                 free_mask: torch.Tensor, new_pix: torch.Tensor,
                 new_valid: torch.Tensor, rho0, F: torch.Tensor | None = None):
    """Recruit linearization and row assembly (A.58 + A.67-A.79) of M
    candidates seen from the camera ``cam_pq`` (r, q): the new landmark
    states, their covariance rows J_cam ``rows7`` (the top 7 rows of the
    covariance they are added to), the candidate-candidate couplings J_m
    ``P77`` J_n^T, and the slots in first-free order. The Jacobians are
    closed form (``landmarks.new_landmark_jacobians``); the couplings are
    averaged with their mirror, so the rows keep P == P^T bit for bit. With
    ``F`` the camera columns are right-multiplied by F^T (the predict;
    landmark rows are predict-invariant). Shared by the fused recruit step
    and ``landmarks.add_landmarks``.
    Returns (y_m [M,6], Rt [6M,D], slots [M], valid [M], idx [6M],
    idx_safe [6M] with D where skipped, v6 [6M])."""
    dtype, dev = rows7.dtype, rows7.device
    D = rows7.shape[1]
    M = new_pix.shape[0]
    rho0 = (params.sal_pnt_init_inv_dist if rho0 is None else rho0).to(dtype)
    rho0_m = torch.broadcast_to(torch.atleast_1d(rho0), (M,))
    y_m, Jc_m, Jp_m, Jr_m = lm_mod.new_landmark_jacobians(
        params, cam_pq, new_pix.to(dtype), rho0_m)
    JcP77 = Jc_m @ P77
    auto_m = lm_mod._auto_covariance(params, JcP77, Jc_m, Jp_m, Jr_m,
                                     params.sal_pnt_init_inv_dist_std)
    cross_m = torch.einsum("mij,jd->mid", Jc_m, rows7)
    newnew = torch.einsum("mik,njk->minj", JcP77, Jc_m)
    eye_m = torch.eye(M, dtype=torch.bool, device=dev)
    blocks = torch.where(eye_m[:, None, :, None], auto_m[:, :, None, :],
                         newnew)

    slots, valid = assign_free_slots(free_mask, new_valid)
    v6 = torch.repeat_interleave(valid, 6)
    offs = _N + torch.where(valid, slots, 0) * 6
    idx = (offs[:, None] + torch.arange(6, device=dev)[None, :]).reshape(-1)
    idx_safe = torch.where(v6, idx, D)

    vvT = valid[:, None, None, None] & valid[None, None, :, None]
    colvals = torch.where(vvT, blocks, 0.0).reshape(6 * M, 6 * M)
    colvals = 0.5 * (colvals + colvals.T)       # bitwise P == P^T invariant
    Rt = scatter_drop(cross_m.reshape(6 * M, D).T, idx_safe, colvals.T).T
    if F is not None:
        Rt = torch.cat([Rt[:, :_N] @ F.T, Rt[:, _N:]], dim=1)
    return y_m, Rt, slots, valid, idx, idx_safe, v6


def fused_update_health_recruit_predict(
    params: MonoSlamParams, x: torch.Tensor, P: torch.Tensor,
    obs: torch.Tensor, obs_mask: torch.Tensor,
    new_pix: torch.Tensor, new_valid: torch.Tensor, free_mask: torch.Tensor,
    *, precomputed: tuple | None = None,
    deactivate_mask: torch.Tensor | None = None,
    rho0: torch.Tensor | None = None,
):
    """``fused_update_health_predict`` with per-frame recruitment spliced in
    at the reference's point: update -> health -> delete -> recruit ->
    predict. A new slot's rows come from the top 7 rows of the post-health,
    post-renorm posterior, rebuilt from P and B without forming it.

    Returns (x_next, P_next, resid, x_post_update, slots [M] int32 with -1
    where not added, chol_info)."""
    Kcap = obs_mask.shape[0]
    M = new_pix.shape[0]
    x1, B, keep, resid, info = _fused_update_core(
        params, x, P, obs, obs_mask, precomputed, deactivate_mask)
    epi = camera_epilogue(params, x1, Kcap)

    with span("frame.recruit"):
        kc = keep[:_N]
        rows7 = (P[:7, :] - B[:, :7].T @ B) * (kc[:7, None] * keep[None, :])
        rows7[3:7, :] = epi.Jq @ rows7[3:7, :]
        rows7[:, 3:7] = rows7[:, 3:7] @ epi.Jq.T
        P77 = 0.5 * (rows7[:, :7] + rows7[:, :7].T)
        y_m, Rt, slots, valid, idx, idx_safe, v6 = recruit_rows(
            params, epi.x2[:7], rows7, P77, free_mask, new_pix, new_valid,
            rho0, epi.F)

    P_next = _fused_covariance_predict(params, P, B, keep, epi.Cp, epi.G)
    _write_sym_stripes(P_next, idx, v6, Rt)
    x_next = scatter_drop(epi.x_next, idx_safe, y_m.reshape(6 * M))
    return x_next, P_next, resid, x1, slots, info
