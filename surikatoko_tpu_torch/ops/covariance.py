"""Symmetric covariance downdate P' = k k^T o (P - M^T M): the hand-written
CUDA kernel and its plain PyTorch version.

``symmetric_downdate`` replaces the Pallas TPU kernel
``surikatoko_tpu/ops/covariance.py:symmetric_downdate``. The port's every
EKF downdate goes through it: the fused frame step's masked downdate
(``keep`` = its 0/1 keep mask) and ``update.stacked_update`` (no mask). For
tensors on the CPU it runs :func:`symmetric_downdate_ref` (the tests' path);
for CUDA tensors it launches ``csrc/symmetric_downdate.cu`` or raises: there
is no fallback. Both versions read only the lower triangle of P and mirror
it, so the result is exactly symmetric. The tile edge comes from D and the
type (:func:`downdate_config`). float32 runs on the FP32 lanes; for its
128-wide tiles the wrapper also allocates the scratch into which a first
kernel copies M with padded rows, so such a call is two device launches.
float64 runs on the FP64 tensor cores (``mma.sync`` m16n8k16 in 64-wide
tiles, DMMA: the rate its bound assumes, 0.49 ms at the flagship's D =
4621, m = 1536), loading M directly, one launch a call. A batch of B
problems of one shape is one launch too (the grid's y axis picks the
problem), each problem's output bit for bit its own call's;
``torch.func.vmap`` reaches it through the dispatcher operator
``surikatoko::symmetric_downdate`` and its vmap rule.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary

# Wrapper calls in this process that launched a CUDA kernel, float32 or
# float64 (the plain version never counts). A float32 call with 128-wide
# tiles is two device launches, the row padding copy and the downdate; it
# counts once. A batch of problems is one call and counts once.
LAUNCHES = 0
# problems a launch: the grid's y extent
MAX_BATCH = 65535

# The library's entry points, float32 and float64, for B problems: (P, M,
# keep, Mp, out, B, D, m, tile, sP, sM, sK, stream) and (P, M, keep, out, B,
# D, m, sP, sM, sK, stream), a problem's tensors s* values after the
# previous one's (0: one tensor shared by every problem). One problem is a
# batch of one, which the library runs without the batch addressing.
_LIB = KernelLibrary(
    "symmetric_downdate.cu", "symmetric_downdate_f32_batched",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p])
_LIB64 = KernelLibrary(
    "symmetric_downdate.cu", "symmetric_downdate_f64_batched",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p])

# Output tile edge by D: D <= TILE_32_MAX_D takes 32, larger D 128. Wider
# tiles reuse each loaded value more but give fewer blocks. In a sweep of
# device time at D = 13 + 6K, m = 2K (tools/probe_downdate.py on an H100;
# PERF.md), 32 was the faster edge at every D up to 1933 but 1549 (4%
# slower there) and 128 at every D from 2317 on.
TILE_32_MAX_D = 1933
# float64 takes the DMMA kernel's 64-wide tiles at every D
F64_TILE = 64


def downdate_config(D: int, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(tile edge, thread blocks) of the kernel for a [D,D] output of
    ``dtype``: one block per lower-triangle tile, the grid the kernel's entry
    point launches."""
    if D < 1:
        raise ValueError(f"D must be >= 1, got {D}")
    if dtype == torch.float64:
        tile = F64_TILE
    else:
        tile = 32 if D <= TILE_32_MAX_D else 128
    nt = -(-D // tile)
    return tile, nt * (nt + 1) // 2


def symmetric_downdate_ref(P: torch.Tensor, M: torch.Tensor,
                           keep: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: X = P o kk^T - (M o k)^T (M o k) (with ``keep=None``,
    P - M^T M), then its lower triangle mirrored up. P [..., D, D], M [...,
    m, D], keep [..., D]: a leading batch dimension is one problem a slice."""
    if P.dim() == 2:
        if keep is None:
            X = torch.addmm(P, M.T, M, alpha=-1)
        else:
            Mk = M * keep[None, :]
            X = torch.addmm(P * (keep[:, None] * keep[None, :]), Mk.T, Mk,
                            alpha=-1)
        return torch.tril(X) + torch.tril(X, -1).T
    lead = P.shape[:-2]
    P, M, keep = _flat(P, M, keep)
    if keep is None:
        X = torch.baddbmm(P, M.mT, M, alpha=-1)
    else:
        Mk = M * keep[:, None, :]
        X = torch.baddbmm(P * (keep[:, :, None] * keep[:, None, :]),
                          Mk.mT, Mk, alpha=-1)
    return (torch.tril(X) + torch.tril(X, -1).mT).reshape(*lead,
                                                          *X.shape[1:])


def _flat(P: torch.Tensor, M: torch.Tensor, keep: torch.Tensor | None):
    """A batch P [*L,D,D] with M [*L,m,D] or [m,D] (shared) and keep [*L,D]
    or [D] (or None), as (P [B,D,D], M [B,m,D], keep [B,D]), B = prod(L); a
    shared argument is expanded without a copy."""
    lead, D = P.shape[:-2], P.shape[-1]
    if M.dim() == 2:
        M = M.expand(*lead, *M.shape)
    if keep is not None and keep.dim() == 1:
        keep = keep.expand(*lead, keep.shape[0])
    _check(P, M, keep)
    return (P.reshape(-1, D, D), M.reshape(-1, M.shape[-2], D),
            None if keep is None else keep.reshape(-1, D))


def _check(P: torch.Tensor, M: torch.Tensor, keep: torch.Tensor | None
           ) -> None:
    """Raise unless P [*L,D,D], M [*L,m,D] and keep [*L,D] (or None) share
    their leading dims L, one float type and one device, with D, m >= 1."""
    ps, ms = P.shape, M.shape
    if (len(ps) < 2 or ps[-2] != ps[-1] or len(ms) != len(ps)
            or ms[:-2] != ps[:-2] or ms[-1] != ps[-1] or ps[-1] < 1
            or ms[-2] < 1 or (keep is not None and keep.shape != ps[:-1])):
        raise ValueError(f"bad shapes: P {tuple(P.shape)}, M {tuple(M.shape)}, "
                         f"keep {None if keep is None else tuple(keep.shape)}")
    if P.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no downdate kernel for {P.dtype}")
    for name, t in (("M", M), ("keep", keep)):
        if t is not None and (t.dtype != P.dtype or t.device != P.device):
            raise ValueError(f"{name} must be a {P.dtype} tensor on {P.device}")


def _slices(t: torch.Tensor, B: int) -> tuple[torch.Tensor, int]:
    """(t with contiguous problems, the values from one problem to the
    next): an axis of stride 0, one tensor shared by every problem (what
    vmap's rule makes of an unbatched argument), is passed without a copy,
    as is the one problem of a batch of one; both step 0."""
    if B == 1:
        return t.contiguous(), 0
    if t.stride(0) == 0:
        return t[:1].contiguous(), 0
    t = t.contiguous()
    return t, t.numel() // B


def _launch(P: torch.Tensor, M: torch.Tensor, keep: torch.Tensor | None,
            B: int) -> torch.Tensor:
    """One launch of the kernel over B problems: P [B,D,D], M [B,m,D], keep
    [B,D] or None (checked), or for B = 1 also P [D,D], M [m,D], keep [D];
    returns out of P's shape."""
    global LAUNCHES
    D, m = P.shape[-1], M.shape[-2]
    if B > MAX_BATCH:
        raise ValueError(f"batch of {B} problems: at most {MAX_BATCH} a launch")
    out = torch.empty_like(P, memory_format=torch.contiguous_format)
    if B == 0:
        return out
    P, sP = _slices(P, B)
    M, sM = _slices(M, B)
    keep_ptr, sK = None, 0
    if keep is not None:
        keep, sK = _slices(keep, B)
        keep_ptr = keep.data_ptr()
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream().cuda_stream
        if P.dtype == torch.float64:
            rc = _LIB64.fn()(P.data_ptr(), M.data_ptr(), keep_ptr,
                             out.data_ptr(), B, D, m, sP, sM, sK, stream)
        else:
            tile = downdate_config(D)[0]
            # 128-wide tiles load M from a copy whose rows are padded to a
            # multiple of 4 floats (16-byte loads); a shared M is padded once
            scratch = (torch.empty((1 if sM == 0 else B, m, -(-D // 4) * 4),
                                   dtype=P.dtype, device=P.device)
                       if tile == 128 else None)
            rc = _LIB.fn()(P.data_ptr(), M.data_ptr(), keep_ptr,
                           None if scratch is None else scratch.data_ptr(),
                           out.data_ptr(), B, D, m, tile, sP, sM, sK, stream)
    if rc != 0:
        raise RuntimeError(f"symmetric_downdate kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def _downdate(P: torch.Tensor, M: torch.Tensor,
              keep: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version for tensors on the CPU, the kernel for CUDA ones:
    one launch for P [D,D] and for a batch P [*L,D,D] (its leading dims L
    flattened into one). M and keep may leave out leading dims of P's (one
    shared by every problem)."""
    if P.device.type == "cpu":
        return symmetric_downdate_ref(P, M, keep)
    if P.device.type != "cuda":
        raise ValueError(f"no downdate kernel for device {P.device}")
    if P.dim() == 2:
        # one problem: a batch of one, without the batch's expand and
        # reshapes (host time that the flagship's frame would pay)
        _check(P, M, keep)
        if not (P.is_contiguous() and M.is_contiguous()
                and (keep is None or keep.is_contiguous())):
            raise ValueError("P, M and keep of one problem must be contiguous")
        return _launch(P, M, keep, 1)
    lead = P.shape[:-2]
    P, M, keep = _flat(P, M, keep)
    return _launch(P, M, keep, P.shape[0]).reshape(*lead, *P.shape[-2:])


@torch.library.custom_op("surikatoko::symmetric_downdate", mutates_args=())
def _downdate_op(P: torch.Tensor, M: torch.Tensor,
                 keep: Optional[torch.Tensor]) -> torch.Tensor:
    """The downdate as an operator of torch's dispatcher, so that
    ``torch.func.vmap`` batches it by :func:`_downdate_vmap`."""
    return _downdate(P, M, keep)


@_downdate_op.register_fake
def _(P, M, keep):
    return torch.empty_like(P)


@_downdate_op.register_vmap
def _downdate_vmap(info, in_dims, P, M, keep):
    """vmap's rule: the batch axes move to the front, an unbatched argument
    (a P, M or keep shared by every problem) is expanded without a copy, and
    the batch is one call: on a card, one launch of the batched kernel."""
    def front(t, d):
        return t.movedim(d, 0) if d is not None else t.expand(
            info.batch_size, *t.shape)
    keep = None if keep is None else front(keep, in_dims[2])
    return _downdate_op(front(P, in_dims[0]), front(M, in_dims[1]), keep), 0


def _batched(*ts) -> bool:
    return any(t is not None and torch._C._functorch.is_batchedtensor(t)
               for t in ts)


def symmetric_downdate(P: torch.Tensor, M: torch.Tensor,
                       keep: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`symmetric_downdate_ref`.
    P [D,D] (symmetric; its lower triangle is read), M [m,D], keep [D] with
    0/1 entries or None; contiguous, all float32 or all float64, on one CUDA
    device, D, m >= 1. float64 runs the DMMA kernel (FP64 tensor cores),
    one launch a call. The values of ``keep`` are not checked (that would
    wait for the card).

    A batch, P [B,D,D] with M [B,m,D] (or [m,D], shared) and keep [B,D] (or
    [D]), is one launch of the batched entry points, as is a call under
    ``torch.func.vmap``: then the dispatcher's operator
    ``surikatoko::symmetric_downdate`` takes it and its vmap rule makes the
    batch. A call with no batched argument goes straight to the kernel, with
    no dispatcher in between. Each problem of a batch equals its own
    unbatched call bit for bit."""
    if _batched(P, M, keep):
        return _downdate_op(P, M, keep)
    return _downdate(P, M, keep)


def build():
    """Compile the kernel library (all its entry points) if it is not built
    yet; returns its path."""
    return _LIB.build()
