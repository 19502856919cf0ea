"""EKF measurement updates: the four strategies of the reference engine, all
masked so that shapes stay fixed, and the products with the block-sparse
observation matrix H.

Port of ``surikatoko_tpu/models/monoslam/update.py`` (reference mapping,
davison-mono-slam.cpp):
  1. stacked_update          <- ProcessFrame_StackedObservationsPerUpdateCore :977
  2. one_obs_update          <- ProcessFrame_OneObservationPerUpdate :1153
  3. one_component_update    <- ProcessFrame_OneComponentOfOneObservationPerUpdate :1525
  4. one_point_ransac_update <- ProcessFrame_OnePointRansacUpdateCore :1393

A = H P and T = A H^T come from the per-slot blocks Hcam [K,2,13] /
Hlm [K,2,6]: small K materializes H densely; at K >= 256 landmarks are
grouped g at a time (g = 64 first) and the landmark half becomes one batched
matmul [K/g, 2g, 6g] x [K/g, 6g, D], skipping the [2K, 6K] sea of zero
blocks.

Differences from the JAX package, by design:
* a masked slot contributes exact zeros even where its projection is not
  finite (:func:`_masked_jacobians`; JAX multiplies by the 0/1 mask and
  keeps the NaN, ROADMAP C.2), and the sequential updates select with
  ``torch.where`` for the same reason. Wherever JAX's result is finite the
  two agree;
* the stacked downdate is the symmetric downdate kernel
  (``ops/covariance``), exactly symmetric by construction;
* the innovation Cholesky is ``torch.linalg.cholesky_ex`` and its ``info``
  is returned last by ``stacked_update`` and ``one_point_ransac_update``;
  2x2 inverses are ``inv_ex``: neither waits for the card;
* ``lax.scan`` over slots is a Python loop with static indices, and the
  RANSAC hypotheses are one batch over slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from surikatoko_tpu_torch.models.monoslam import measure
from surikatoko_tpu_torch.models.monoslam.state import (
    CAM_STATE_COMPS,
    MonoSlamParams,
)
from surikatoko_tpu_torch.ops.covariance import symmetric_downdate
from surikatoko_tpu_torch.utils.profiling import span

_N = CAM_STATE_COMPS
_CHI2_99_2DOF = 9.21034


class UpdateInfo(NamedTuple):
    resid_before: torch.Tensor      # [K,2] masked innovation before update
    obs_count: torch.Tensor         # number of observations used
    low_innov_count: torch.Tensor   # RANSAC stage-1 size (0 for other impls)
    high_innov_count: torch.Tensor  # RANSAC stage-2 size


def _masked_jacobians(params: MonoSlamParams, x: torch.Tensor,
                      obs_mask: torch.Tensor):
    """(h [K,2], Hcam [K,2,13], Hlm [K,2,6], use [K]) with use = obs_mask
    and a finite row (h, Hcam, Hlm all finite). Rows not in use are exact
    zeros: a freed XYZ slot at the camera's position projects to NaN, and
    0 * NaN would poison the whole update."""
    h, Hcam, Hlm = measure.measurement_jacobians(params, x)
    K = obs_mask.shape[0]
    use = (obs_mask & torch.isfinite(h).all(dim=-1)
           & torch.isfinite(Hcam.reshape(K, -1)).all(dim=-1)
           & torch.isfinite(Hlm.reshape(K, -1)).all(dim=-1))
    return (torch.where(use[:, None], h, 0.0),
            torch.where(use[:, None, None], Hcam, 0.0),
            torch.where(use[:, None, None], Hlm, 0.0), use)


def _dense_h(Hcam: torch.Tensor, Hlm: torch.Tensor) -> torch.Tensor:
    """H [2K, 13+6K] from the per-slot blocks."""
    K = Hcam.shape[0]
    eye = torch.eye(K, dtype=Hcam.dtype, device=Hcam.device)
    lm_block = torch.einsum("kij,kl->kilj", Hlm, eye).reshape(2 * K, 6 * K)
    return torch.cat([Hcam.reshape(2 * K, _N), lm_block], dim=1)


def _h_group(K: int) -> int:
    """Landmark-group size of the blocked products, or 0 for dense."""
    if K < 256:
        return 0
    for g in (64, 128, 32):
        if K % g == 0:
            return g
    return 0


def _lm_blocks(Hlm: torch.Tensor, g: int) -> torch.Tensor:
    """Block-diagonal H landmark groups [K/g, 2g, 6g]."""
    G = Hlm.shape[0] // g
    eye = torch.eye(g, dtype=Hlm.dtype, device=Hlm.device)
    return torch.einsum("maij,ab->maibj", Hlm.reshape(G, g, 2, 6),
                        eye).reshape(G, 2 * g, 6 * g)


def hp_blocked(Hcam: torch.Tensor, Hlm: torch.Tensor, P: torch.Tensor,
               group: int) -> torch.Tensor:
    """A = H P [2K, D] as a camera matmul plus one grouped bmm."""
    K, D = Hcam.shape[0], P.shape[-1]
    G = K // group
    P_lm = P[_N:, :].reshape(G, 6 * group, D)
    A_lm = torch.bmm(_lm_blocks(Hlm, group), P_lm).reshape(2 * K, D)
    return Hcam.reshape(2 * K, _N) @ P[:_N, :] + A_lm


def aht_blocked(A2: torch.Tensor, Hcam: torch.Tensor, Hlm: torch.Tensor,
                group: int) -> torch.Tensor:
    """T = A H^T [2K, 2K] with the same grouped block-diagonal structure."""
    K = Hcam.shape[0]
    G = K // group
    A_lm = A2[:, _N:].reshape(2 * K, G, 6 * group).transpose(0, 1)
    T_lm = torch.bmm(A_lm, _lm_blocks(Hlm, group).transpose(1, 2))
    T_lm = T_lm.transpose(0, 1).reshape(2 * K, 2 * K)
    return A2[:, :_N] @ Hcam.reshape(2 * K, _N).T + T_lm


def hp_auto(Hcam: torch.Tensor, Hlm: torch.Tensor, P: torch.Tensor
            ) -> torch.Tensor:
    """A = H P [2K, D]: blocked at large K, dense otherwise."""
    g = _h_group(Hcam.shape[0])
    if g:
        return hp_blocked(Hcam, Hlm, P, g)
    return _dense_h(Hcam, Hlm) @ P


def aht_auto(A2: torch.Tensor, Hcam: torch.Tensor, Hlm: torch.Tensor
             ) -> torch.Tensor:
    """T = A H^T [2K, 2K]: blocked at large K, dense otherwise."""
    g = _h_group(Hcam.shape[0])
    if g:
        return aht_blocked(A2, Hcam, Hlm, g)
    return A2 @ _dense_h(Hcam, Hlm).T


def _hp(Hcam: torch.Tensor, Hlm: torch.Tensor, P: torch.Tensor
        ) -> torch.Tensor:
    """A = H P as [K,2,D]."""
    return hp_auto(Hcam, Hlm, P).reshape(Hcam.shape[0], 2, P.shape[-1])


def stacked_update(params: MonoSlamParams, x: torch.Tensor, P: torch.Tensor,
                   obs: torch.Tensor, obs_mask: torch.Tensor):
    """One stacked EKF update over all observed slots: A = H P,
    S = A H^T + R = C C^T, B = C^-1 A, x' = x + B^T C^-1 r,
    P' = P - B^T B (reference :1004-1114). Returns (x', P', masked
    residual [K,2], Cholesky info)."""
    Kcap = obs_mask.shape[0]
    dtype = x.dtype
    with span("frame.update"):
        h, Hcam, Hlm, use = _masked_jacobians(params, x, obs_mask)
        resid = torch.where(use[:, None], obs - h, 0.0)
        A2 = hp_auto(Hcam, Hlm, P)                       # [2K, D] = H P
        r_var = params.measurm_noise_var.to(dtype)
        S2 = aht_auto(A2, Hcam, Hlm) + r_var * torch.eye(
            2 * Kcap, dtype=dtype, device=x.device)
        C, info = torch.linalg.cholesky_ex(S2)
        # one triangular solve for the whitened gain and the whitened residual
        By = torch.linalg.solve_triangular(
            C, torch.cat([A2, resid.reshape(2 * Kcap, 1)], dim=1), upper=False)
        B, y = By[:, :-1], By[:, -1]
        x_new = x + B.T @ y                              # = P H^T S^-1 r
        P_new = symmetric_downdate(P, B.contiguous())    # = P - K S K^T
    return x_new, P_new, resid, info


def _slot_jacobian(params: MonoSlamParams, x: torch.Tensor, slot: int):
    """(h [2], Hcam [2,13], Hlm [2,6]) of one slot: the closed-form
    Jacobians (the values JAX's jacfwd gives)."""
    lo = _N + 6 * slot
    h, Hcam, Hlm = measure.batched_jacobians(params, x[:_N], x[lo:lo + 6][None])
    return h[0], Hcam[0], Hlm[0]


def _rank2_gain(P: torch.Tensor, slot: int, Hcam: torch.Tensor,
                Hlm: torch.Tensor, r_var: torch.Tensor):
    """P H_k^T [D,m] and S_k [m,m] for one observation block k (m = 2 for a
    pixel, 1 for one component)."""
    lo = _N + 6 * slot
    PHt = P[:, :_N] @ Hcam.T + P[:, lo:lo + 6] @ Hlm.T
    S = Hcam @ PHt[:_N] + Hlm @ PHt[lo:lo + 6]
    return PHt, S + r_var * torch.eye(Hcam.shape[0], dtype=P.dtype,
                                      device=P.device)


def one_obs_update(params: MonoSlamParams, x: torch.Tensor, P: torch.Tensor,
                   obs: torch.Tensor, obs_mask: torch.Tensor):
    """Sequential rank-2 updates, one observation at a time, relinearized at
    the running state (reference :1153-1523); masked slots are no-ops.
    Returns (x', P', residual [K,2] before the update). Each slot writes the
    whole [D,D] covariance: O(K) passes over P per frame."""
    r_var = params.measurm_noise_var.to(x.dtype)
    h0 = measure.measurement_jacobians(params, x)[0]
    resid0 = torch.where(obs_mask[:, None], obs - h0, 0.0)
    for slot in range(obs_mask.shape[0]):
        h, Hcam, Hlm = _slot_jacobian(params, x, slot)
        PHt, S = _rank2_gain(P, slot, Hcam, Hlm, r_var)
        Kg = PHt @ torch.linalg.inv_ex(S)[0]                  # [D,2]
        use = obs_mask[slot]
        x = torch.where(use, x + Kg @ (obs[slot] - h), x)
        P = torch.where(use, P - Kg @ S @ Kg.T, P)
        P = 0.5 * (P + P.T)
    return x, P, resid0


def one_component_update(params: MonoSlamParams, x: torch.Tensor,
                         P: torch.Tensor, obs: torch.Tensor,
                         obs_mask: torch.Tensor):
    """Sequential scalar (rank-1) updates, each pixel coordinate on its own
    (reference :1525-1649). Returns (x', P', residual before)."""
    r_var = params.measurm_noise_var.to(x.dtype)
    h0 = measure.measurement_jacobians(params, x)[0]
    resid0 = torch.where(obs_mask[:, None], obs - h0, 0.0)
    for idx in range(2 * obs_mask.shape[0]):
        slot, comp = divmod(idx, 2)
        h, Hcam, Hlm = _slot_jacobian(params, x, slot)
        PHt, S = _rank2_gain(P, slot, Hcam[comp:comp + 1], Hlm[comp:comp + 1],
                             r_var)                           # [D,1], [1,1]
        s = S[0, 0]
        Kg = PHt / s
        use = obs_mask[slot]
        x = torch.where(use, x + Kg @ (obs[slot] - h)[comp:comp + 1], x)
        P = torch.where(use, P - s * (Kg @ Kg.T), P)
        P = 0.5 * (P + P.T)
    return x, P, resid0


def _own_cols(A: torch.Tensor) -> torch.Tensor:
    """[K,a,6] slot-own landmark columns of a per-slot [K,a,13+6K] block."""
    K, a = A.shape[0], A.shape[1]
    return torch.diagonal(A[:, :, _N:].reshape(K, a, K, 6), dim1=0,
                          dim2=2).permute(2, 0, 1)


def one_point_ransac_update(
    params: MonoSlamParams, x: torch.Tensor, P: torch.Tensor,
    obs: torch.Tensor, obs_mask: torch.Tensor,
):
    """Civera 1-point RANSAC (reference :1271-1523). Stage 1: every matched
    observation is a hypothesis; its rank-2 state-only update is applied,
    all landmarks are projected through the hypothesis state, and the
    matches within ``params.ransac_corner_max_divergence_pix`` (None: the
    pixel noise std) count as its support. The best hypothesis's support
    (the low-innovation inliers) drives a stacked update. Stage 2: the
    remaining matches within the chi-square gate
    ``params.ransac_high_innov_chi_square_thresh`` (None: 9.21034) of the
    updated prediction (high-innovation inliers) get a second stacked
    update. The hypotheses run as one batch over slots.

    Returns (x', P', residual before, low count, high count, Cholesky info:
    the larger of the two stacked updates' infos, each counted only where
    its stage applies)."""
    Kcap = obs_mask.shape[0]
    dtype, dev = x.dtype, x.device
    D = x.shape[0]
    r_var = params.measurm_noise_var.to(dtype)
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    thr = params.ransac_corner_max_divergence_pix
    if thr is None:
        thr = torch.sqrt(r_var)
    chi2_thr = params.ransac_high_innov_chi_square_thresh
    if chi2_thr is None:
        chi2_thr = _CHI2_99_2DOF

    h0, Hcam0, Hlm0 = measure.measurement_jacobians(params, x)
    resid0 = torch.where(obs_mask[:, None], obs - h0, 0.0)

    # stage 1: slot k's rank-2 gain from its own Jacobian at x, all k at once
    P_lm = P[:, _N:].reshape(D, Kcap, 6)
    PHt = (torch.einsum("dc,kic->kdi", P[:, :_N], Hcam0)
           + torch.einsum("dkl,kil->kdi", P_lm, Hlm0))           # [K,D,2]
    S = (Hcam0 @ PHt[:, :_N, :] + r_var * eye2
         + Hlm0 @ _own_cols(PHt.transpose(1, 2)).transpose(1, 2))
    Kg = PHt @ torch.linalg.inv_ex(S)[0]                         # [K,D,2]
    x_hyp = x + (Kg @ (obs - h0)[:, :, None])[..., 0]            # [K,D]
    dist = torch.linalg.norm(obs - measure.project_all(params, x_hyp), dim=-1)
    supports = obs_mask[None, :] & (dist < thr)                  # [K,K]
    counts = torch.where(obs_mask, supports.sum(dim=1, dtype=torch.int32), -1)
    best = torch.argmax(counts)        # only matched slots hypothesize
    low_mask = torch.index_select(supports, 0, best.reshape(1))[0] & obs_mask
    any_low = low_mask.any()
    x1, P1, _, info1 = stacked_update(params, x, P, obs, low_mask)
    x1 = torch.where(any_low, x1, x)
    P1 = torch.where(any_low, P1, P)

    # stage 2: chi-square gate on the updated state
    h1, Hcam1, Hlm1, use1 = _masked_jacobians(params, x1, obs_mask)
    A1 = _hp(Hcam1, Hlm1, P1)                                    # [K,2,D]
    S1 = (torch.einsum("kid,kjd->kij", A1[:, :, :_N], Hcam1)
          + torch.einsum("kid,kjd->kij", _own_cols(A1), Hlm1) + r_var * eye2)
    diff = obs - h1
    chi2 = torch.einsum("ki,kij,kj->k", diff, torch.linalg.inv_ex(S1)[0], diff)
    high_mask = use1 & ~low_mask & (chi2 < chi2_thr)
    any_high = high_mask.any()
    x2, P2, _, info2 = stacked_update(params, x1, P1, obs, high_mask)
    x2 = torch.where(any_high, x2, x1)
    P2 = torch.where(any_high, P2, P1)
    info = torch.maximum(torch.where(any_low, info1, 0),
                         torch.where(any_high, info2, 0))
    return (x2, P2, resid0, low_mask.sum(dtype=torch.int32),
            high_mask.sum(dtype=torch.int32), info)
