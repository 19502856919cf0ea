"""Gated ZNCC surface argmax: the hand-written CUDA kernel and its plain
PyTorch version.

``ncc_surface_argmax`` replaces the Pallas TPU kernel
``surikatoko_tpu/ops/ncc_pallas.py:ncc_surface_argmax_pallas``. For tensors
on the CPU it runs :func:`ncc_surface_argmax_ref` (the tests' path); for CUDA
tensors it launches ``csrc/ncc_search.cu`` or raises: there is no fallback.

The kernel is compiled with nvcc on first use (``ops/cuda_build``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
from surikatoko_tpu_torch.vision import templ_match

# Launches of the CUDA kernel in this process (the plain version never counts).
LAUNCHES = 0

_LIB = KernelLibrary(
    "ncc_search.cu", "ncc_surface_argmax_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def ncc_surface_argmax_ref(patches: torch.Tensor, templates: torch.Tensor,
                           gate: torch.Tensor, with_neigh: bool = False,
                           templ_stats: templ_match.TemplateStats | None = None):
    """Plain version: (best_corr [K], best_idx [K] int32[, neigh [K,4]]) of
    the gated ZNCC surface; ``neigh`` is the raw (ungated) surface at the
    argmax's x-1, x+1, y-1, y+1 cells, index-clamped to the window (the
    caller masks cells outside it). Ties go to the lower flat index.
    ``templ_stats`` (cached template mean and norm) replaces the ones the
    surface would form from ``templates``."""
    K, S, _ = gate.shape
    if templ_stats is not None:
        templ_stats = templ_match.TemplateStats(
            *(t.to(patches.dtype) for t in templ_stats))
    surf = templ_match.corr_coeff_surface(patches, templates, templ_stats)
    flat = torch.where(gate, surf, -torch.inf).reshape(K, S * S)
    best = torch.argmax(flat, dim=1)
    best_corr = torch.take_along_dim(flat, best[:, None], dim=1)[:, 0]
    res = (best_corr, best.to(torch.int32))
    if with_neigh:
        d = torch.as_tensor([-1, 1, -S, S], device=best.device)
        nb = torch.clamp(best[:, None] + d[None, :], 0, S * S - 1)
        res = res + (torch.take_along_dim(surf.reshape(K, S * S), nb, dim=1),)
    return res


def ncc_surface_argmax(patches: torch.Tensor, templates: torch.Tensor,
                       gate: torch.Tensor, with_neigh: bool = False,
                       templ_stats: templ_match.TemplateStats | None = None):
    """Kernel wrapper, same contract as :func:`ncc_surface_argmax_ref`.
    patches [K,P,P] f32, templates [K,T,T] f32, gate [K,S,S] bool with
    S = P - T + 1, all contiguous and on one device. The kernel forms each
    template's mean and norm itself (csrc/ncc_search.cu), so on the card
    ``templ_stats`` is checked for shape and not used; on the CPU the plain
    surface takes it."""
    global LAUNCHES
    if patches.device.type == "cpu":
        return ncc_surface_argmax_ref(patches, templates, gate, with_neigh,
                                      templ_stats)
    if patches.device.type != "cuda":
        raise ValueError(f"no NCC kernel for device {patches.device}")
    K, P, P2 = patches.shape
    T = templates.shape[-1]
    S = P - T + 1
    if (P != P2 or S < 1 or templates.shape != (K, T, T)
            or gate.shape != (K, S, S)):
        raise ValueError(f"bad shapes: patches {tuple(patches.shape)}, "
                         f"templates {tuple(templates.shape)}, "
                         f"gate {tuple(gate.shape)}")
    if templ_stats is not None and any(t.shape != (K,) for t in templ_stats):
        raise ValueError(f"templ_stats must hold two [K] tensors, K = {K}")
    for name, t, dt in (("patches", patches, torch.float32),
                        ("templates", templates, torch.float32),
                        ("gate", gate, torch.bool)):
        if t.dtype != dt or not t.is_contiguous() or t.device != patches.device:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{patches.device}")
    launch = _LIB.fn()
    corr = torch.empty(K, dtype=torch.float32, device=patches.device)
    idx = torch.empty(K, dtype=torch.int32, device=patches.device)
    neigh = (torch.empty((K, 4), dtype=torch.float32, device=patches.device)
             if with_neigh else None)
    with torch.cuda.device(patches.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            patches.data_ptr(), templates.data_ptr(), gate.data_ptr(),
            corr.data_ptr(), idx.data_ptr(),
            neigh.data_ptr() if with_neigh else None,
            K, P, T, int(with_neigh), stream)
    if rc != 0:
        raise RuntimeError(f"ncc_search kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return (corr, idx) if not with_neigh else (corr, idx, neigh)


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path."""
    return _LIB.build()
