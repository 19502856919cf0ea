"""Gated ZNCC surface argmax: the hand-written CUDA kernel and its plain
PyTorch version.

``ncc_surface_argmax`` replaces the Pallas TPU kernel
``surikatoko_tpu/ops/ncc_pallas.py:ncc_surface_argmax_pallas``. For tensors
on the CPU it runs :func:`ncc_surface_argmax_ref` (the tests' path); for CUDA
tensors it launches ``csrc/ncc_search.cu`` or raises: there is no fallback.

The kernel is compiled with nvcc on first use into ``_build/`` next to this
package, as a shared library with a plain C entry point loaded through
ctypes; the library's name carries a hash of the source and the flags, so a
changed source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from surikatoko_tpu_torch.vision import templ_match

# Launches of the CUDA kernel in this process (the plain version never counts).
LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "ncc_search.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_lib = None


def ncc_surface_argmax_ref(patches: torch.Tensor, templates: torch.Tensor,
                           gate: torch.Tensor, with_neigh: bool = False):
    """Plain version: (best_corr [K], best_idx [K] int32[, neigh [K,4]]) of
    the gated ZNCC surface; ``neigh`` is the raw (ungated) surface at the
    argmax's x-1, x+1, y-1, y+1 cells, index-clamped to the window (the
    caller masks cells outside it). Ties go to the lower flat index."""
    K, S, _ = gate.shape
    surf = templ_match.corr_coeff_surface(patches, templates)
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
                       gate: torch.Tensor, with_neigh: bool = False):
    """Kernel wrapper, same contract as :func:`ncc_surface_argmax_ref`.
    patches [K,P,P] f32, templates [K,T,T] f32, gate [K,S,S] bool with
    S = P - T + 1, all contiguous and on one device."""
    global LAUNCHES
    if patches.device.type == "cpu":
        return ncc_surface_argmax_ref(patches, templates, gate, with_neigh)
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
    for name, t, dt in (("patches", patches, torch.float32),
                        ("templates", templates, torch.float32),
                        ("gate", gate, torch.bool)):
        if t.dtype != dt or not t.is_contiguous() or t.device != patches.device:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{patches.device}")
    lib = _load()
    corr = torch.empty(K, dtype=torch.float32, device=patches.device)
    idx = torch.empty(K, dtype=torch.int32, device=patches.device)
    neigh = (torch.empty((K, 4), dtype=torch.float32, device=patches.device)
             if with_neigh else None)
    with torch.cuda.device(patches.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ncc_surface_argmax_f32(
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
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libncc_search_{tag}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the NCC kernel cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.ncc_surface_argmax_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib
