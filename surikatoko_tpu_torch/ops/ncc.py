"""Batched ellipse-gated NCC search over all landmarks at once.

Port of ``surikatoko_tpu/ops/ncc.py`` (reference ImageTemplCornersMatcher::
MatchSalientPointTemplCenterInRect, demo-davison-mono-slam.cpp:465-579):
gather [K,P,P] search patches, gate the S x S candidate cells by the
innovation ellipse (with the min-search-rect floor and the image border),
and take the gated ZNCC argmax through ``ncc_cuda.ncc_surface_argmax`` (the
hand-written kernel on the card, its plain version on the CPU). Fixed
shapes throughout; no host synchronization.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from surikatoko_tpu_torch.ops import ncc_cuda
from surikatoko_tpu_torch.vision import templ_match


class NccSearchResult(NamedTuple):
    best_center: torch.Tensor   # [K,2] (x,y) of best template center
    best_corr: torch.Tensor     # [K]
    matched: torch.Tensor       # [K] bool (gate passed & corr above threshold)
    n_gated: torch.Tensor       # [K] int32: candidate cells passing the gate
    in_ellipse: torch.Tensor    # [K] bool: best cell inside the strict ellipse


def _gather_patches(image: torch.Tensor, top_left: torch.Tensor, P: int
                    ) -> torch.Tensor:
    """[K,P,P] patches at integer (x, y) top-left corners, clamped inside."""
    H, W = image.shape
    ar = torch.arange(P, device=image.device)
    y = torch.clamp(top_left[:, 1], 0, H - P)[:, None] + ar
    x = torch.clamp(top_left[:, 0], 0, W - P)[:, None] + ar
    return image[y[:, :, None], x[:, None, :]]


def search_window(image: torch.Tensor, centers: torch.Tensor, T: int,
                  R: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each landmark's search window around its rounded predicted center
    (clamped inside the image): (patches [K,P,P], candidate template-center
    x and y [K,S,S]) with S = 2R + 1, P = S + T - 1."""
    S = 2 * R + 1
    P = S + T - 1
    H, W = image.shape
    half = (T - 1) // 2
    centers_i = torch.round(centers).to(torch.int32)   # half to even, as jnp
    patch_tl = centers_i - (half + R)
    tl = torch.stack([torch.clamp(patch_tl[:, 0], 0, W - P),
                      torch.clamp(patch_tl[:, 1], 0, H - P)], dim=1)
    ar = torch.arange(S, device=image.device)
    oy, ox = torch.meshgrid(ar, ar, indexing="ij")
    cand_x = tl[:, 0, None, None] + ox[None] + half      # [K,S,S]
    cand_y = tl[:, 1, None, None] + oy[None] + half
    return _gather_patches(image, tl, P), cand_x, cand_y


def ncc_search(image: torch.Tensor, centers: torch.Tensor,
               templates: torch.Tensor, active: torch.Tensor, *,
               search_radius: int, min_corr_coeff: float = 0.5,
               sigma_inv: torch.Tensor | None = None,
               chi2_gate: float | None = None,
               templ_stats: templ_match.TemplateStats | None = None,
               min_search_rect: int = 7,
               subpixel: bool = False) -> NccSearchResult:
    """Each landmark's best template placement within ``search_radius`` of
    its predicted center (``centers`` [K,2] float (x,y)). ``subpixel`` fits
    1-D parabolas through the raw surface at the best cell's 4-neighbours;
    a best cell on the window edge keeps its integer center on that axis.
    ``templ_stats`` goes to the plain surface on the CPU; the kernel forms
    the templates' mean and norm itself and only checks its shape."""
    K, T, _ = templates.shape
    R = search_radius
    S = 2 * R + 1
    H, W = image.shape
    dtype, dev = image.dtype, image.device
    half = (T - 1) // 2
    patches, cand_x, cand_y = search_window(image, centers, T, R)
    ar = torch.arange(S, device=dev)
    oy, ox = torch.meshgrid(ar, ar, indexing="ij")

    gate = torch.ones((K, S, S), dtype=torch.bool, device=dev)
    strict = gate
    if sigma_inv is not None and chi2_gate is not None:
        dx = cand_x.to(dtype) - centers[:, 0, None, None]
        dy = cand_y.to(dtype) - centers[:, 1, None, None]
        md = (sigma_inv[:, None, None, 0, 0] * dx * dx
              + 2.0 * sigma_inv[:, None, None, 0, 1] * dx * dy
              + sigma_inv[:, None, None, 1, 1] * dy * dy)
        strict = md <= chi2_gate
        # the predicted center stays searchable (reference min search rect)
        rr = torch.maximum(torch.abs(ox - R), torch.abs(oy - R))
        gate = strict | (rr <= (min_search_rect - 1) // 2)[None]
    inside = ((cand_x >= half) & (cand_x < W - half)
              & (cand_y >= half) & (cand_y < H - half))
    gate = gate & inside
    n_gated = gate.reshape(K, S * S).sum(dim=1, dtype=torch.int32)

    res = ncc_cuda.ncc_surface_argmax(
        patches.to(torch.float32).contiguous(),
        templates.to(torch.float32).contiguous(), gate.contiguous(),
        with_neigh=subpixel, templ_stats=templ_stats)
    best_corr, best = res[0].to(dtype), res[1].to(torch.int64)
    flat_x = cand_x.reshape(K, S * S)
    flat_y = cand_y.reshape(K, S * S)
    bx = torch.take_along_dim(flat_x, best[:, None], dim=1)[:, 0]
    by = torch.take_along_dim(flat_y, best[:, None], dim=1)[:, 0]

    matched = active & (best_corr >= min_corr_coeff) & torch.isfinite(best_corr)
    best_center = torch.stack([bx, by], dim=1).to(dtype)
    in_ellipse = torch.take_along_dim(
        strict.expand(K, S, S).reshape(K, S * S), best[:, None], dim=1)[:, 0]

    if subpixel:
        c_n = res[2].to(dtype)
        bx_off = best % S
        by_off = best // S
        c0 = best_corr
        den_x = c_n[:, 0] - 2.0 * c0 + c_n[:, 1]
        den_y = c_n[:, 2] - 2.0 * c0 + c_n[:, 3]
        d_x = torch.clamp(0.5 * (c_n[:, 0] - c_n[:, 1])
                          / torch.where(den_x < -1e-9, den_x, -1.0), -0.5, 0.5)
        d_y = torch.clamp(0.5 * (c_n[:, 2] - c_n[:, 3])
                          / torch.where(den_y < -1e-9, den_y, -1.0), -0.5, 0.5)
        ok_x = ((den_x < -1e-9) & (bx_off > 0) & (bx_off < S - 1)
                & (bx - 1 >= half) & (bx + 1 < W - half))
        ok_y = ((den_y < -1e-9) & (by_off > 0) & (by_off < S - 1)
                & (by - 1 >= half) & (by + 1 < H - half))
        best_center = best_center + torch.stack(
            [torch.where(ok_x, d_x, 0.0), torch.where(ok_y, d_y, 0.0)],
            dim=1).to(dtype)

    return NccSearchResult(best_center=best_center, best_corr=best_corr,
                           matched=matched, n_gated=n_gated,
                           in_ellipse=in_ellipse)


def make_ncc_search(search_radius: int, min_corr_coeff: float = 0.5,
                    chi2_gate: float | None = None, min_search_rect: int = 7,
                    subpixel: bool = False):
    """:func:`ncc_search` with its static parameters bound. The port has one
    route, the kernel on the card and its plain version on the CPU, so the
    JAX package's ``use_pallas`` switch has no counterpart."""
    return functools.partial(
        ncc_search, search_radius=search_radius, min_corr_coeff=min_corr_coeff,
        chi2_gate=chi2_gate, min_search_rect=min_search_rect, subpixel=subpixel)
