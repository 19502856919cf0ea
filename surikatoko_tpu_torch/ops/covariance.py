"""Symmetric covariance downdate P' = k k^T o (P - M^T M): the hand-written
CUDA kernel and its plain PyTorch version.

``symmetric_downdate`` replaces the Pallas TPU kernel
``surikatoko_tpu/ops/covariance.py:symmetric_downdate``. The port's every
EKF downdate goes through it: the fused frame step's masked downdate
(``keep`` = its 0/1 keep mask) and ``update.stacked_update`` (no mask). For
tensors on the CPU it runs :func:`symmetric_downdate_ref` (the tests' path);
for CUDA tensors it launches ``csrc/symmetric_downdate.cu`` or raises: there
is no fallback. Both versions read only the lower triangle of P and mirror
it, so the result is exactly symmetric. The kernel's tile edge comes from D
(:func:`downdate_config`); for 128-wide tiles the wrapper also allocates the
scratch into which a first kernel copies M with padded rows, so such a call
is two device launches.
"""

from __future__ import annotations

import ctypes

import torch

from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary

# Wrapper calls in this process that launched the CUDA kernel (the plain
# version never counts). A call with 128-wide tiles is two device launches,
# the row padding copy and the downdate; it counts once.
LAUNCHES = 0

_LIB = KernelLibrary(
    "symmetric_downdate.cu", "symmetric_downdate_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])

# Output tile edge by D: D <= TILE_32_MAX_D takes 32, larger D 128. Wider
# tiles reuse each loaded value more but give fewer blocks. In a sweep of
# device time at D = 13 + 6K, m = 2K (tools/probe_downdate.py on an H100;
# PERF.md), 32 was the faster edge at every D up to 1933 but 1549 (4%
# slower there) and 128 at every D from 2317 on.
TILE_32_MAX_D = 1933


def downdate_config(D: int) -> tuple[int, int]:
    """(tile edge, thread blocks) of the kernel for a [D,D] output: one block
    per lower-triangle tile, the grid the kernel's entry point launches."""
    if D < 1:
        raise ValueError(f"D must be >= 1, got {D}")
    tile = 32 if D <= TILE_32_MAX_D else 128
    nt = -(-D // tile)
    return tile, nt * (nt + 1) // 2


def symmetric_downdate_ref(P: torch.Tensor, M: torch.Tensor,
                           keep: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: X = P o kk^T - (M o k)^T (M o k) (with ``keep=None``,
    P - M^T M), then its lower triangle mirrored up."""
    if keep is None:
        X = torch.addmm(P, M.T, M, alpha=-1)
    else:
        Mk = M * keep[None, :]
        X = torch.addmm(P * (keep[:, None] * keep[None, :]), Mk.T, Mk, alpha=-1)
    return torch.tril(X) + torch.tril(X, -1).T


def symmetric_downdate(P: torch.Tensor, M: torch.Tensor,
                       keep: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`symmetric_downdate_ref`.
    P [D,D] (symmetric; its lower triangle is read), M [m,D], keep [D] with
    0/1 entries or None; contiguous float32 on one CUDA device, D, m >= 1.
    The values of ``keep`` are not checked (that would wait for the card)."""
    global LAUNCHES
    if P.device.type == "cpu":
        return symmetric_downdate_ref(P, M, keep)
    if P.device.type != "cuda":
        raise ValueError(f"no downdate kernel for device {P.device}")
    D = P.shape[0]
    if (P.dim() != 2 or P.shape[1] != D or M.dim() != 2 or M.shape[1] != D
            or D < 1 or M.shape[0] < 1
            or (keep is not None and tuple(keep.shape) != (D,))):
        raise ValueError(f"bad shapes: P {tuple(P.shape)}, M {tuple(M.shape)}, "
                         f"keep {None if keep is None else tuple(keep.shape)}")
    for name, t in (("P", P), ("M", M), ("keep", keep)):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                              or t.device != P.device):
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{P.device}")
    launch = _LIB.fn()
    m = M.shape[0]
    tile = downdate_config(D)[0]
    out = torch.empty_like(P)
    # 128-wide tiles load M from a copy whose rows are padded to a multiple
    # of 4 floats (16-byte loads)
    scratch = (torch.empty((m, -(-D // 4) * 4), dtype=P.dtype, device=P.device)
               if tile == 128 else None)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(P.data_ptr(), M.data_ptr(),
                    None if keep is None else keep.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    out.data_ptr(), D, m, tile, stream)
    if rc != 0:
        raise RuntimeError(f"symmetric_downdate kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def build():
    """Compile the kernel library if it is not built yet; returns its path."""
    return _LIB.build()
