"""The plain reference of one frame of the image-sequence loop with
recruitment: render -> ellipse-gated NCC search -> delete-unobserved ->
Shi-Tomasi candidates, filtered near tracked landmarks -> local depth
prior -> the fused update, recruit rows and predict.

Copied from the port's ``world/device_runner`` (``render_frame``,
``init_imageseq``, ``make_imageseq_scan_runner``'s frame body with
``recruit=True``), ``ops/ncc`` with ``vision/templ_match`` (the search and
its plain surface) and ``vision/features``, over the frozen modules beside
this file. Everything runs in the state's dtype, the NCC surface too (the
port takes it in float32, on the card in kernel B1), except the corner
response, which the reference detector (like the port's and OpenCV's)
forms in float32 whatever the image's dtype.

Tie rule of the search: the surface is rounded to float32 before its
argmax and the threshold, and equal rounded scores go to the lower flat
index, as kernel B1 breaks ties: cells that float32 cannot tell apart are
equal here too, and no wider. A program in float32 renders the frame and
scores the cells with errors far above that rounding (up to ~7e-4 in a
score on the card, PERF.md §2), so it can take a neighbouring cell of a
weak match where the reference does not; the cell's x_err limit admits
such a move of one landmark.

Everything here is float64 in the benchmark's check, where the TF32
switches do not apply; the harness turns them off before a run
(``lib/cell.full_precision``), and only the control, this module in
float32, runs with them on.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import camera as cam_mod
from . import fused_step as fused_mod
from . import landmarks as lm_mod
from . import measure
from . import predict as predict_mod
from . import update as update_mod
from .fused_step import scatter_drop
from .state import MonoSlamParams, MonoSlamState, init_state


class ImageWorldT(NamedTuple):
    gt_cfw_R: torch.Tensor    # [F,3,3]
    gt_cfw_t: torch.Tensor    # [F,3]
    points: torch.Tensor      # [N,3]
    background: torch.Tensor  # [H,W]
    splat_amp: torch.Tensor
    splat_sigma: torch.Tensor


def world_tensors(world, dtype, device) -> ImageWorldT:
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return ImageWorldT(t(world.gt_cfw_R), t(world.gt_cfw_t), t(world.points),
                       t(world.background), t(world.splat_amp),
                       t(world.splat_sigma))


# ---- render ------------------------------------------------------------------

def render_frame(params: MonoSlamParams, w: ImageWorldT, f: int
                 ) -> torch.Tensor:
    """[H,W]: the background plus a gaussian blob at every GT point in
    front of the camera, clamped to [0, 255]."""
    H, W = w.background.shape
    dtype, dev = w.background.dtype, w.background.device
    xc = w.points @ w.gt_cfw_R[f].T + w.gt_cfw_t[f]
    dist = params.dist if params.enable_distortion else None
    pix = cam_mod.project_camera_point(params.cam, dist, xc)
    finite = torch.isfinite(pix)
    vis = (xc[:, 2] > 1e-6) & finite.all(dim=-1)
    pix = torch.where(finite, pix, -1e6)
    inv2s2 = 1.0 / (2.0 * w.splat_sigma * w.splat_sigma)
    xs = torch.arange(W, dtype=dtype, device=dev)
    ys = torch.arange(H, dtype=dtype, device=dev)
    ex = torch.exp(-(xs[None, :] - pix[:, 0:1]) ** 2 * inv2s2)    # [N,W]
    ey = torch.exp(-(ys[None, :] - pix[:, 1:2]) ** 2 * inv2s2)    # [N,H]
    a = w.splat_amp * vis.to(dtype)
    img = w.background + (ey * a[:, None]).T @ ex
    return torch.clamp(img, 0.0, 255.0)


def gather_templates(image: torch.Tensor, centers: torch.Tensor, T: int
                     ) -> torch.Tensor:
    """[K,T,T] patches centred at the rounded, clamped pixel centres."""
    H, W = image.shape
    ci = torch.round(centers).to(torch.int32) - (T - 1) // 2
    ar = torch.arange(T, device=image.device)
    y = torch.clamp(ci[:, 1], 0, H - T)[:, None] + ar
    x = torch.clamp(ci[:, 0], 0, W - T)[:, None] + ar
    return image[y[:, :, None], x[:, None, :]]


# ---- gated NCC search ------------------------------------------------------------

def _depthwise_corr(patches: torch.Tensor, kernels: torch.Tensor
                    ) -> torch.Tensor:
    """patches [K,P,P] (x) kernels [K,T,T] -> valid correlation [K,S,S]."""
    K = patches.shape[0]
    return F.conv2d(patches[None], kernels[:, None], groups=K)[0]


def corr_coeff_surface(patches: torch.Tensor, templates: torch.Tensor,
                       eps: float = 1e-12) -> torch.Tensor:
    """ZNCC surface [K,S,S] of each search patch against its template
    (reference templ-match.cpp:7-112); ~zero-variance windows get 0."""
    K, T = patches.shape[0], templates.shape[-1]
    n = T * T
    mean = templates.mean(dim=(-2, -1))
    d = templates - mean[:, None, None]
    t_norm = torch.sqrt(torch.sum(d * d, dim=(-2, -1)))
    corr_prod = _depthwise_corr(patches, d)
    ones = torch.ones((K, T, T), dtype=patches.dtype, device=patches.device)
    win_sum = _depthwise_corr(patches, ones)
    win_sum2 = _depthwise_corr(patches * patches, ones)
    var_term = torch.clamp(win_sum2 - win_sum * win_sum / n, min=0.0)
    denom = torch.sqrt(var_term) * t_norm[:, None, None]
    ok = denom > eps
    return torch.where(ok, corr_prod / torch.where(ok, denom, 1.0), 0.0)


class SearchResult(NamedTuple):
    best_center: torch.Tensor   # [K,2]
    best_corr: torch.Tensor     # [K] float32-rounded score
    matched: torch.Tensor       # [K] bool


def ncc_search(image: torch.Tensor, centers: torch.Tensor,
               templates: torch.Tensor, active: torch.Tensor,
               sigma_inv: torch.Tensor, *, search_radius: int,
               min_corr_coeff: float, chi2_gate: float,
               min_search_rect: int) -> SearchResult:
    """Each landmark's best template placement within ``search_radius``
    of its rounded predicted centre, among the cells inside the innovation
    ellipse (chi-square ``chi2_gate``), the ``min_search_rect`` square
    about the centre and the image's border (reference ImageTemplCorners-
    Matcher::MatchSalientPointTemplCenterInRect, demo-davison-mono-slam.
    cpp:465-579). Integer centres (no subpixel refinement)."""
    K, T, _ = templates.shape
    R = search_radius
    S = 2 * R + 1
    P = S + T - 1
    H, W = image.shape
    dtype, dev = image.dtype, image.device
    half = (T - 1) // 2
    ci = torch.round(centers).to(torch.int32)      # half to even
    tl_x = torch.clamp(ci[:, 0] - (half + R), 0, W - P)
    tl_y = torch.clamp(ci[:, 1] - (half + R), 0, H - P)
    arP = torch.arange(P, device=dev)
    patches = image[(tl_y[:, None] + arP)[:, :, None],
                    (tl_x[:, None] + arP)[:, None, :]]
    ar = torch.arange(S, device=dev)
    oy, ox = torch.meshgrid(ar, ar, indexing="ij")
    cand_x = tl_x[:, None, None] + ox[None] + half       # [K,S,S]
    cand_y = tl_y[:, None, None] + oy[None] + half

    dx = cand_x.to(dtype) - centers[:, 0, None, None]
    dy = cand_y.to(dtype) - centers[:, 1, None, None]
    md = (sigma_inv[:, None, None, 0, 0] * dx * dx
          + 2.0 * sigma_inv[:, None, None, 0, 1] * dx * dy
          + sigma_inv[:, None, None, 1, 1] * dy * dy)
    rr = torch.maximum(torch.abs(ox - R), torch.abs(oy - R))
    gate = (md <= chi2_gate) | (rr <= (min_search_rect - 1) // 2)[None]
    gate = gate & ((cand_x >= half) & (cand_x < W - half)
                   & (cand_y >= half) & (cand_y < H - half))

    surf = corr_coeff_surface(patches, templates.to(dtype))
    flat = torch.where(gate, surf.to(torch.float32),
                       -torch.inf).reshape(K, S * S)
    # argmax returns the first of equal maxima: the lower flat index
    best = torch.argmax(flat, dim=1)
    best_corr = torch.take_along_dim(flat, best[:, None], dim=1)[:, 0]
    bx = torch.take_along_dim(cand_x.reshape(K, S * S), best[:, None], 1)[:, 0]
    by = torch.take_along_dim(cand_y.reshape(K, S * S), best[:, None], 1)[:, 0]
    matched = (active & (best_corr >= min_corr_coeff)
               & torch.isfinite(best_corr))
    return SearchResult(torch.stack([bx, by], dim=1).to(dtype), best_corr,
                        matched)


# ---- Shi-Tomasi candidates ------------------------------------------------------

def _sep_filter(img: torch.Tensor, kv, kh) -> torch.Tensor:
    """Separable zero-padded 'SAME' filter: vertical taps kv, then
    horizontal taps kh, summed in tap order."""
    H, W = img.shape
    rv = (len(kv) - 1) // 2
    p = F.pad(img, (0, 0, rv, rv))
    v = sum(float(k) * p[i:i + H] for i, k in enumerate(kv) if k != 0.0)
    rh = (len(kh) - 1) // 2
    p = F.pad(v, (rh, rh, 0, 0))
    return sum(float(k) * p[:, j:j + W] for j, k in enumerate(kh) if k != 0.0)


def _sep_maxpool(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 window max with -inf padding."""
    H, W = x.shape
    p = F.pad(x, (0, 0, radius, radius), value=-torch.inf)
    v = functools.reduce(torch.maximum,
                         (p[i:i + H] for i in range(2 * radius + 1)))
    p = F.pad(v, (radius, radius, 0, 0), value=-torch.inf)
    return functools.reduce(torch.maximum,
                            (p[:, j:j + W] for j in range(2 * radius + 1)))


def shi_tomasi_response(image: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Min-eigenvalue response of the structure tensor, in float32."""
    img = image.to(torch.float32)
    gx = _sep_filter(img, (0.125, 0.25, 0.125), (-1.0, 0.0, 1.0))
    gy = _sep_filter(img, (-1.0, 0.0, 1.0), (0.125, 0.25, 0.125))
    ones = (1.0,) * window
    a = _sep_filter(gx * gx, ones, ones)
    b = _sep_filter(gx * gy, ones, ones)
    c = _sep_filter(gy * gy, ones, ones)
    det_rad = torch.sqrt(torch.clamp((a - c) ** 2 + 4 * b * b, min=0.0))
    return 0.5 * ((a + c) - det_rad)


def detect_corners(image: torch.Tensor, max_corners: int, nms_radius: int,
                   border: int, quality_level: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``max_corners`` strongest Shi-Tomasi corners, strongest first:
    peaks of their (2 nms_radius + 1)^2 window, ``border`` pixels inside
    the image, at least ``quality_level`` of the frame's strongest.
    (xy [N,2] float32, valid [N]). Taken from all peaks by a sort, where
    the port reduces 4x4 tiles first; peaks closer than the radius are
    one peak, so the two agree but for equal responses."""
    H, W = image.shape
    dev = image.device
    resp = shi_tomasi_response(image)
    is_peak = (resp >= _sep_maxpool(resp, nms_radius)) & (resp > 0)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inside = ((xs >= border) & (xs < W - border)
              & (ys >= border) & (ys < H - border))
    thresh = quality_level * resp.max()
    score = torch.where(is_peak & inside & (resp >= thresh), resp,
                        -torch.inf).reshape(-1)
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:max_corners], idx[:max_corners]
    xy = torch.stack([idx % W, idx // W], dim=1).to(torch.float32)
    return xy, torch.isfinite(vals)


def filter_out_closest(candidates: torch.Tensor, cand_valid: torch.Tensor,
                       existing: torch.Tensor, exist_valid: torch.Tensor,
                       min_dist: float) -> torch.Tensor:
    """Drop candidates within ``min_dist`` of a valid existing point
    (reference FilterOutClosest, demo-davison-mono-slam.cpp:828)."""
    d2 = torch.sum((candidates[:, None, :] - existing[None, :, :]) ** 2,
                   dim=-1)
    d2 = torch.where(exist_valid[None, :], d2, torch.inf)
    return cand_valid & (d2.min(dim=1).values >= min_dist ** 2)


# ---- the loop ------------------------------------------------------------------

def init_imageseq(params: MonoSlamParams, w: ImageWorldT, K: int, T: int
                  ) -> tuple[MonoSlamState, torch.Tensor]:
    """Frame 0: every GT point visible in it claims a slot in order with
    its GT inverse depth, and its template is cut from the rendered frame;
    then one predict."""
    dtype, dev = w.points.dtype, w.points.device
    img0 = render_frame(params, w, 0)
    xc0 = w.points @ w.gt_cfw_R[0].T + w.gt_cfw_t[0]
    dist = params.dist if params.enable_distortion else None
    pix = cam_mod.project_camera_point(params.cam, dist, xc0)
    H, W = img0.shape
    vis = ((xc0[:, 2] > 1e-6) & (pix[:, 0] >= 0) & (pix[:, 0] < W)
           & (pix[:, 1] >= 0) & (pix[:, 1] < H))
    rho = 1.0 / torch.clamp(torch.linalg.norm(xc0, dim=-1), min=1e-9)
    st, slots = lm_mod.add_landmarks(params, init_state(K, dtype=dtype,
                                                        device=dev),
                                     pix, vis, rho)
    templates = scatter_drop(
        torch.zeros((K, T, T), dtype=dtype, device=dev),
        torch.where(slots >= 0, slots, K).long(),
        gather_templates(img0, pix, T))
    return predict_mod.predict(params, st), templates


class Predicted(NamedTuple):
    h: torch.Tensor           # [K,2] predicted pixels (0 where not finite)
    A_un: torch.Tensor        # [2K,D] H P
    T_un: torch.Tensor        # [2K,2K] H P H^T
    sigma_inv: torch.Tensor   # [K,2,2] inverse 2x2 innovation blocks
    row_ok: torch.Tensor      # [K] the slot's prediction is finite


def predicted(params: MonoSlamParams, st: MonoSlamState) -> Predicted:
    """The predicted pixels, H P, H P H^T and each slot's inverse 2x2
    innovation block (T_un's diagonal blocks plus the measurement noise),
    shared by the search's ellipse and the update."""
    dtype = st.x.dtype
    K = st.capacity
    h, Hcam, Hlm = measure.measurement_jacobians(params, st.x)
    row_ok = (torch.isfinite(h).all(dim=-1)
              & torch.isfinite(Hcam.reshape(K, -1)).all(dim=-1)
              & torch.isfinite(Hlm.reshape(K, -1)).all(dim=-1))
    h = torch.where(row_ok[:, None], h, 0.0)
    Hcam = torch.where(row_ok[:, None, None], Hcam, 0.0)
    Hlm = torch.where(row_ok[:, None, None], Hlm, 0.0)
    A_un = update_mod.hp_auto(Hcam, Hlm, st.P)
    T_un = update_mod.aht_auto(A_un, Hcam, Hlm)
    S2 = (torch.diagonal(T_un.reshape(K, 2, K, 2), dim1=0, dim2=2)
          .permute(2, 0, 1)
          + params.measurm_noise_var * torch.eye(2, dtype=dtype,
                                                 device=h.device))
    det = S2[:, 0, 0] * S2[:, 1, 1] - S2[:, 0, 1] * S2[:, 1, 0]
    det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    sigma_inv = torch.stack([
        torch.stack([S2[:, 1, 1], -S2[:, 0, 1]], -1),
        torch.stack([-S2[:, 1, 0], S2[:, 0, 0]], -1)], -2) / det[:, None, None]
    return Predicted(h, A_un, T_un, sigma_inv, row_ok)


def image_step(params: MonoSlamParams, w: ImageWorldT, st: MonoSlamState,
               templates: torch.Tensor, f: int, rc: dict
               ) -> tuple[MonoSlamState, torch.Tensor]:
    """Frame ``f`` of the loop from (``st``, ``templates``), with the
    runner settings ``rc``: (state, templates) predicted for frame f + 1."""
    img = render_frame(params, w, f)
    dtype = st.x.dtype
    K = st.capacity
    T = rc["templ_width"]
    h, A_un, T_un, sigma_inv, row_ok = predicted(params, st)
    res = ncc_search(img, h, templates, st.lm_active, sigma_inv,
                     search_radius=rc["search_radius"],
                     min_corr_coeff=rc["min_corr_coeff"],
                     chi2_gate=rc["chi2_gate"],
                     min_search_rect=rc["min_search_rect"])
    obs = res.best_center
    obs_mask = res.matched & st.lm_active & row_ok

    # delete-unobserved (reference :799-840)
    unobs = torch.where(obs_mask, 0, st.lm_unobserved + 1)
    mu = params.max_undetected_frames
    drop = (mu > 0) & (unobs > mu) & st.lm_active
    active_after = st.lm_active & ~drop

    cand_xy, cand_ok = detect_corners(
        img, rc["detector_corners"], rc["detector_nms_radius"], T,
        rc["detector_quality"])
    cur_pos = torch.where(res.matched[:, None], obs, h)
    cand_ok = filter_out_closest(cand_xy, cand_ok, cur_pos, active_after,
                                 rc["recruit_min_dist"])
    sel = torch.argsort((~cand_ok).to(torch.int32),
                        stable=True)[:rc["recruit_max"]]
    new_pix = cand_xy[sel].to(dtype)
    new_valid = cand_ok[sel]
    if rc["recruit_depth"] != "local":
        raise ValueError("the reference takes the local depth prior only")
    rho0 = fused_mod.local_tracked_inv_depth(params, st.x, active_after, K,
                                             new_pix, cur_pos)

    x_next, P_next, _, _, slots, _ = fused_mod.fused_update_health_recruit_predict(
        params, st.x, st.P, obs, obs_mask, new_pix, new_valid, ~active_after,
        precomputed=(h, A_un, T_un), deactivate_mask=drop, rho0=rho0)
    slot_safe = torch.where(slots >= 0, slots, K).long()
    claimed = scatter_drop(torch.zeros_like(active_after), slot_safe,
                           torch.ones_like(new_valid))
    templates = scatter_drop(templates, slot_safe,
                             gather_templates(img, new_pix, T)
                             .to(templates.dtype))
    return st._replace(
        x=x_next, P=P_next, lm_active=active_after | claimed,
        lm_unobserved=torch.where(claimed, 0, unobs),
        lm_generation=st.lm_generation + claimed.to(torch.int32)), templates
