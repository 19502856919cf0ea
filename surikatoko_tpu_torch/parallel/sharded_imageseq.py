"""Landmark-sharded on-device imageseq closed loop: render -> ellipse-gated
NCC template search -> fused EKF update/health/(recruit)/predict, over a
process group.

Port of ``surikatoko_tpu/parallel/sharded_imageseq.py``, the multi-rank twin
of ``world/device_runner.make_imageseq_scan_runner``. Each of the n ranks
holds L = K / n slots (their covariance rows, templates and counters) and
the same share of the world's splats:

  render      each rank splats its own points ([H,N/n] @ [N/n,W]); ONE
              all_reduce assembles the frame
  ellipse     slot k's 2x2 innovation needs only the replicated camera
              stripe and slot k's own rows and columns: local
  NCC search  kernel B1 (``ops/ncc.ncc_search``) over the own slots, on the
              assembled frame
  delete      local unobserved counters; the drop mask rides the frame's
              gather into the keep congruence
  EKF         ``sharded_ekf.fused_step_local`` with the unmasked A rows of
              the ellipse: ONE packed all_gather a frame (H, A, residuals,
              the own diagonal, the drop, active and match masks and, with
              recruitment, the tracked positions), then the downdate of the
              own rows through kernel B2's row-slab form
  recruit     the detector on the assembled frame, suppression against
              every rank's tracked positions and the first-free slot order
              from that same gather; the owner rank writes a new slot's
              rows and template, every rank its columns

The frame body never waits for the card (no ``.item()``, fixed shapes);
the full P and the per-slot tensors are gathered once, after the last
frame.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from surikatoko_tpu_torch.geom import camera as cam_mod
from surikatoko_tpu_torch.models.monoslam import fused_step as fused_mod
from surikatoko_tpu_torch.models.monoslam.fused_step import scatter_drop
from surikatoko_tpu_torch.models.monoslam.state import (
    CAM_STATE_COMPS,
    MonoSlamParams,
)
from surikatoko_tpu_torch.ops.ncc import ncc_search
from surikatoko_tpu_torch.parallel import sharded_ekf as se
from surikatoko_tpu_torch.vision import features
from surikatoko_tpu_torch.world.device_runner import (
    ImageSeqDeviceScenario,
    _gather_templates,
)

_N = CAM_STATE_COMPS


def render_local(params: MonoSlamParams, sc: ImageSeqDeviceScenario,
                 pts: torch.Tensor, f: int) -> torch.Tensor:
    """This rank's partial frame [H,W]: the splats of its points ``pts``
    (``device_runner.render_frame``'s separable contraction), to be summed
    over the ranks and added to the background."""
    H, W = sc.background.shape
    dtype, dev = sc.background.dtype, sc.background.device
    xc = pts @ sc.gt_cfw_R[f].T + sc.gt_cfw_t[f]
    dist_ = params.dist if params.enable_distortion else None
    pix = cam_mod.project_camera_point(params.cam, dist_, xc)
    finite = torch.isfinite(pix)
    vis = (xc[:, 2] > 1e-6) & finite.all(dim=-1)
    pix = torch.where(finite, pix, -1e6)
    inv2s2 = 1.0 / (2.0 * sc.splat_sigma * sc.splat_sigma)
    xs = torch.arange(W, dtype=dtype, device=dev)
    ys = torch.arange(H, dtype=dtype, device=dev)
    ex = torch.exp(-(xs[None, :] - pix[:, 0:1]) ** 2 * inv2s2)
    ey = torch.exp(-(ys[None, :] - pix[:, 1:2]) ** 2 * inv2s2)
    a = sc.splat_amp * vis.to(dtype)
    return (ey * a[:, None]).T @ ex


def _search_ellipse(params, sh: se.Shard, A, Hcam, Hlm):
    """Per-slot inverse 2x2 innovation [L,2,2] of the own slots: (H P
    H^T)_kk + R from the camera columns and slot k's own 6 columns of A."""
    L, D = sh.L, A.shape[-1]
    dtype = A.dtype
    A_own = A[:, :, sh.col0:sh.col0 + 6 * L].reshape(L, 2, L, 6)
    A_slot = torch.diagonal(A_own, dim1=0, dim2=2).permute(2, 0, 1)
    S2 = (torch.einsum("kid,kjd->kij", A[:, :, :_N], Hcam)
          + torch.einsum("kid,kjd->kij", A_slot, Hlm)
          + params.measurm_noise_var * torch.eye(2, dtype=dtype,
                                                 device=A.device))
    det = S2[:, 0, 0] * S2[:, 1, 1] - S2[:, 0, 1] * S2[:, 1, 0]
    det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    return torch.stack([
        torch.stack([S2[:, 1, 1], -S2[:, 0, 1]], -1),
        torch.stack([-S2[:, 1, 0], S2[:, 0, 0]], -1)], -2) / det[:, None, None]


def make_sharded_imageseq_runner(params: MonoSlamParams, capacity: int,
                                 group=None, *, templ_width: int = 15,
                                 search_radius: int = 7,
                                 min_corr_coeff: float = 0.6,
                                 chi2_gate: float = 5.99146,
                                 subpixel: bool = False,
                                 recruit: bool = False,
                                 recruit_max: int = 8,
                                 detector_corners: int = 24,
                                 detector_quality: float = 0.05,
                                 detector_nms_radius: int = 5,
                                 recruit_min_dist: float = 14.0,
                                 target_active: int | None = None,
                                 recruit_depth: str = "prior"):
    """The imageseq closed loop landmark-sharded over ``group`` (None: the
    world), with the options of ``device_runner.make_imageseq_scan_runner``
    (update impl 1). The world may hold more splats than the filter has
    slots; its point count must divide by the group's size.

    Returns run(x, P, templates, lm_active, lm_unobserved, sc, frames) ->
    (x, P, lm_active, lm_unobserved, (err, n_matched, cam_pos, chol_info));
    with ``recruit=True`` run(x, P, templates, lm_active, lm_unobserved,
    lm_generation, sc, frames) -> (x, P, templates, lm_active,
    lm_unobserved, lm_generation, (err, n_matched, cam_pos, n_recruited,
    n_active, chol_info)). Inputs and outputs are the full, replicated
    ones (every rank passes the same); outputs are stacked over frames."""
    if recruit_depth not in ("prior", "median", "local"):
        raise ValueError(f"unknown recruit_depth {recruit_depth!r}")
    sh = se.shard_of(group, capacity)
    L = sh.L
    own = slice(sh.rank * L, (sh.rank + 1) * L)
    mu = params.max_undetected_frames

    def frame(sc, pts, x, P_cam, P_rows, tm, active, unobs, gen, f):
        dtype = x.dtype
        part = render_local(params, sc, pts, f)
        dist.all_reduce(part, group=sh.group)
        img = torch.clamp(sc.background + part, 0.0, 255.0)

        h, Hcam, Hlm, A, row_ok = se.local_products(params, x, P_cam, P_rows,
                                                    sh)
        res = ncc_search(img, h, tm, active, search_radius=search_radius,
                         min_corr_coeff=min_corr_coeff,
                         sigma_inv=_search_ellipse(params, sh, A, Hcam, Hlm),
                         chi2_gate=chi2_gate, subpixel=subpixel)
        obs = res.best_center
        mask = res.matched & active & row_ok
        unobs = torch.where(mask, 0, unobs + 1)
        drop = (mu > 0) & (unobs > mu) & active
        active = active & ~drop

        parts = se.frame_parts(params, x, P_cam, P_rows, sh, obs, mask,
                                     precomputed=(h, Hcam, Hlm, A))
        flags = torch.stack([drop, active, mask], dim=1).to(dtype)
        extra = [flags]
        if recruit:
            extra.append(torch.where(res.matched[:, None], obs, h))
        gathered = se.gather_packed(parts + extra, sh)
        g = se.unpack(gathered[:5], P_cam)
        flags_all = gathered[5] > 0.5
        active_all, n = flags_all[:, 1], flags_all[:, 2].sum()
        g = g._replace(drop=flags_all[:, 0], free=~active_all)

        if not recruit:
            x_next, P_cam, P_rows, x1, info = se.fused_step_local(
                params, sh, x, P_cam, P_rows, g)
            err = (torch.linalg.norm(g.resid, dim=-1).sum()
                   / torch.clamp(n, min=1))
            return (x_next, P_cam, P_rows, tm, active, unobs, gen,
                    (err, n, x1[:3], info))

        cur_pos_all = gathered[6]
        cand_xy, cand_ok = features.detect_corners(
            img, max_corners=detector_corners, nms_radius=detector_nms_radius,
            border=templ_width, quality_level=detector_quality)
        cand_ok = features.filter_out_closest(cand_xy, cand_ok, cur_pos_all,
                                              active_all, recruit_min_dist)
        sel = torch.argsort((~cand_ok).to(torch.int32),
                            stable=True)[:recruit_max]
        new_pix = cand_xy[sel].to(dtype)
        new_valid = cand_ok[sel]
        if target_active is not None:
            budget = torch.clamp(target_active - active_all.sum(), 0,
                                 recruit_max)
            new_valid = new_valid & (torch.arange(new_valid.shape[0],
                                                  device=new_valid.device)
                                     < budget)
        if recruit_depth == "median":
            rho0 = fused_mod.median_tracked_inv_depth(params, x, active_all,
                                                      capacity)
        elif recruit_depth == "local":
            rho0 = fused_mod.local_tracked_inv_depth(
                params, x, active_all, capacity, new_pix, cur_pos_all)
        else:
            rho0 = None
        x_next, P_cam, P_rows, x1, info, slots = se.fused_step_local(
            params, sh, x, P_cam, P_rows, g,
            recruit=(new_pix, new_valid, rho0))
        # the own slots' bookkeeping; a slot of another rank lands on the
        # scratch entry L
        slot_loc = slots - sh.rank * L
        slot_loc = torch.where((slots >= 0) & (slot_loc >= 0) & (slot_loc < L),
                               slot_loc, L)
        claimed = scatter_drop(torch.zeros_like(active), slot_loc,
                               torch.ones_like(new_valid))
        tm = scatter_drop(tm, slot_loc, _gather_templates(
            img, new_pix, templ_width).to(tm.dtype))
        n_rec = (slots >= 0).sum()
        err = torch.linalg.norm(g.resid, dim=-1).sum() / torch.clamp(n, min=1)
        return (x_next, P_cam, P_rows, tm, active | claimed,
                torch.where(claimed, 0, unobs), gen + claimed.to(gen.dtype),
                (err, n, x1[:3], n_rec, active_all.sum() + n_rec, info))

    def run_frames(x, P, templates, lm_active, lm_unobserved, lm_generation,
                   sc, frames):
        n_pts = sc.gt_points.shape[0]
        if n_pts % sh.n:
            raise ValueError(f"{n_pts} world points do not divide by "
                             f"{sh.n} ranks")
        npl = n_pts // sh.n
        pts = sc.gt_points[sh.rank * npl:(sh.rank + 1) * npl]
        P_cam, P_rows = se.split_rows(P, sh)
        tm, active = templates[own], lm_active[own]
        unobs, gen = lm_unobserved[own], lm_generation[own]
        outs = []
        for f in frames:
            (x, P_cam, P_rows, tm, active, unobs, gen, out) = frame(
                sc, pts, x, P_cam, P_rows, tm, active, unobs, gen, int(f))
            outs.append(out)
        out = tuple(torch.stack(o) for o in zip(*outs))
        gat = lambda t: se.all_gather_rows(t, sh)
        # bool as uint8: gloo gathers no bool
        return (x, se.assemble(P_cam, P_rows, sh), gat(tm),
                gat(active.to(torch.uint8)).bool(), gat(unobs), gat(gen), out)

    if recruit:
        return run_frames

    def run(x, P, templates, lm_active, lm_unobserved, sc, frames):
        gen0 = torch.zeros_like(lm_unobserved)
        x, P, _tm, active, unobs, _gen, out = run_frames(
            x, P, templates, lm_active, lm_unobserved, gen0, sc, frames)
        return x, P, active, unobs, out

    return run
