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
type and, in float32, from the batch (:func:`downdate_config`, whose rule
comes from a sweep on an H100). float32 runs on the FP32 lanes in one of
the forms of F32_FORMS; for its 128-wide tiles the wrapper also allocates
the scratch into which a first kernel copies M with padded rows, so such a
call is two device launches.
float64 runs on the FP64 tensor cores (``mma.sync`` m16n8k16 in 64-wide
tiles, DMMA: the rate its bound assumes, 0.49 ms at the flagship's D =
4621, m = 1536), loading M directly, one launch a call. A batch of B
problems of one shape is one launch too (the grid's y axis picks the
problem), each problem's output bit for bit its own call's;
``torch.func.vmap`` reaches it through the dispatcher operator
``surikatoko::symmetric_downdate`` and its vmap rule.

``symmetric_downdate_rows`` computes rows [r0, r0 + R) of the same output
from those rows of P alone, for the landmark-sharded filter
(``parallel/sharded_ekf``): the kernel's row-slab entry points, each element
bit for bit what the full call writes there when P is exactly symmetric;
its plain version, :func:`symmetric_downdate_rows_ref`, equals the matching
rows of :func:`symmetric_downdate_ref` likewise (on the CPU's BLAS, whose
product element does not depend on the rows asked for). A slab of few rows
(the camera rows) takes the thin kernels, one launch; a larger one the full
call's tiles, in float32 laid from the slab's first row with a short last
wave split in halves (:func:`rows_config`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
from surikatoko_tpu_torch.utils.profiling import count, span

# The counters (``utils.profiling.count``): "b2.calls", host calls that
# launched the kernel, float32 or float64 (the plain version never counts;
# a float32 call with 128-wide tiles is two device launches, the row
# padding copy and the downdate, and a batch of problems is one call: each
# counts once), and "b2.rows_calls", the row-slab calls
# (symmetric_downdate_rows) that launched it, counted alike.

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
# The row-slab entry points: (P_rows, M, keep, Mp, out, D, m, r0, R, tile,
# split, stream) and (P_rows, M, keep, out, D, m, r0, R, stream)
_LIB_ROWS = KernelLibrary(
    "symmetric_downdate.cu", "symmetric_downdate_rows_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_LIB_ROWS64 = KernelLibrary(
    "symmetric_downdate.cu", "symmetric_downdate_rows_f64",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# The thin slab's: (P_rows, M, keep, out, D, m, r0, R, cw, stream), f32 and f64
_THIN_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_LIB_THIN = KernelLibrary("symmetric_downdate.cu",
                          "symmetric_downdate_rows_thin_f32", _THIN_ARGS)
_LIB_THIN64 = KernelLibrary("symmetric_downdate.cu",
                            "symmetric_downdate_rows_thin_f64", _THIN_ARGS)

class F32Form(NamedTuple):
    """A float32 form of the tile kernel (csrc/symmetric_downdate.cu:Form,
    its template arguments in order): tile x tile output tiles, a thread's
    tm x tn register tile, kp rows of M a panel through a ring of
    ``stages``, M from the row-padded copy (``padded``: 16-byte loads, one
    launch more) or straight from M, ``min_blocks`` blocks an SM (launch
    bounds), ``skip``: a warp with no output of its tile runs no FMA, and
    ``epi`` loads of P in flight a thread in the epilogue."""
    name: str
    tile: int
    tm: int
    tn: int
    kp: int
    stages: int
    padded: bool
    min_blocks: int
    skip: bool = False
    epi: int = 4

    @property
    def threads(self) -> int:
        return (self.tile // self.tm) * (self.tile // self.tn)


# The float32 forms by the index the library's entry points take, in the
# order of csrc/symmetric_downdate.cu:launch_form: PR 4's 32- and 128-wide
# tiles, and PR 14's small-D forms
F32_FORMS = (
    F32Form("Tile32", 32, 4, 4, 32, 3, False, 4),
    F32Form("Tile128", 128, 8, 8, 32, 3, True, 2),
    F32Form("Small16", 16, 2, 2, 32, 3, False, 8, True),
    F32Form("Small32", 32, 4, 2, 32, 3, False, 4, True, 8),
    F32Form("Batch32", 32, 4, 4, 16, 3, False, 8, True),
)
TILE32, TILE128, SMALL16, SMALL32, BATCH32 = range(len(F32_FORMS))

# The tile edge up to which float32 takes 32-wide tiles (and 16-wide), 128
# above: PR 4's rule for one problem (in a sweep of device time at
# D = 13 + 6K, m = 2K, 32 was the faster edge at every D up to 1933 but
# 1549, 128 from 2317 on). It holds for the full call and the row slab; a
# slab's element equals the full call's whatever the full call's form: one
# fmaf chain an element.
TILE_32_MAX_D = 1933
# The float32 rule up to TILE_32_MAX_D (f32_form), read off a sweep of B
# problems of [D,D] for B in 1 .. 128, D in 43 .. 2317, m in 32 .. 192
# (tools/probe_downdate.py --small on an H100; PERF.md): Small16 while its
# grid is at most SMALL16_BLOCKS_PER_SM blocks an SM (up to ~2x faster than
# Tile32 there), else Small32 while its grid is at most
# SMALL32_BLOCKS_PER_SM blocks an SM (up to 1.3x; at 4 blocks an SM, one
# problem of D = 1000, it lost to Tile32 at m = 192), else Batch32 when its
# grid is at least BATCH32_BLOCKS_PER_SM blocks an SM (up to 1.17x), else
# Tile32.
SMALL16_BLOCKS_PER_SM = 2
SMALL32_BLOCKS_PER_SM = 3
BATCH32_BLOCKS_PER_SM = 8
# float64 takes the DMMA kernel's 64-wide tiles at every D, 128 threads, a
# ring of 4 panels (csrc/symmetric_downdate.cu:Cfg64)
F64_TILE, F64_THREADS, F64_STAGES = 64, 128, 4

# Row slabs (rows_config). A slab of at most THIN_MAX_R rows takes the thin
# kernel: a block 16 of its rows against thin_width columns. In the sweeps
# of tools/probe_downdate.py --slabs on an H100 at D = 4621, m = 1536
# (PERF.md) the thin kernel beat the tiles by 1.7x at 128 rows in float32
# (by 4% at 256; the tiles won at 576) and up to 64 rows in float64 (the
# DMMA tiles won at 128).
THIN_MAX_R = {torch.float32: 128, torch.float64: 64}
# blocks of 128-wide float32 tiles resident on an SM (launch bounds and
# shared memory)
TILE128_BLOCKS_PER_SM = 2
# the SMs of an H100 SXM, for a config asked for without a card
H100_SMS = 132


class DowndateConfig(NamedTuple):
    """The kernel of a call: its tile edge, thread blocks (one a
    lower-triangle tile and problem), float32 form (an index of F32_FORMS;
    None for float64, the DMMA kernel), threads a block and ring stages."""
    tile: int
    blocks: int
    form: Optional[int]
    threads: int
    stages: int


def _tiles(D: int, tile: int) -> int:
    """Lower-triangle tiles of a [D,D] output in tile x tile tiles."""
    nt = -(-D // tile)
    return nt * (nt + 1) // 2


def f32_form(D: int, B: int = 1, sms: int = H100_SMS) -> int:
    """The float32 form (an index of F32_FORMS) for B problems of [D,D] on a
    card of ``sms`` SMs (the rule above F32_FORMS)."""
    if D > TILE_32_MAX_D:
        return TILE128
    if B * _tiles(D, 16) <= SMALL16_BLOCKS_PER_SM * sms:
        return SMALL16
    if B * _tiles(D, 32) <= SMALL32_BLOCKS_PER_SM * sms:
        return SMALL32
    if B * _tiles(D, 32) >= BATCH32_BLOCKS_PER_SM * sms:
        return BATCH32
    return TILE32


def slab_tile(D: int, dtype: torch.dtype = torch.float32) -> int:
    """The tile edge of a row slab of a [D,D] output of ``dtype``: PR 4's
    float32 edge (32 up to TILE_32_MAX_D, else 128), the DMMA kernel's in
    float64."""
    if dtype == torch.float64:
        return F64_TILE
    return 32 if D <= TILE_32_MAX_D else 128


def downdate_config(D: int, dtype: torch.dtype = torch.float32, B: int = 1,
                    sms: int = H100_SMS) -> DowndateConfig:
    """The kernel's configuration for B problems of a [D,D] output of
    ``dtype`` on a card of ``sms`` SMs: the form and the grid and block its
    entry point launches."""
    if D < 1 or B < 1:
        raise ValueError(f"D and B must be >= 1, got D={D}, B={B}")
    if dtype == torch.float64:
        return DowndateConfig(F64_TILE, B * _tiles(D, F64_TILE), None,
                              F64_THREADS, F64_STAGES)
    form = f32_form(D, B, sms)
    f = F32_FORMS[form]
    return DowndateConfig(f.tile, B * _tiles(D, f.tile), form, f.threads,
                          f.stages)


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
            form = f32_form(D, B, sm_count(P.device))
            # a padded form loads M from a copy whose rows are padded to a
            # multiple of 4 floats (16-byte loads); a shared M is padded once
            scratch = (torch.empty((1 if sM == 0 else B, m, -(-D // 4) * 4),
                                   dtype=P.dtype, device=P.device)
                       if F32_FORMS[form].padded else None)
            rc = _LIB.fn()(P.data_ptr(), M.data_ptr(), keep_ptr,
                           None if scratch is None else scratch.data_ptr(),
                           out.data_ptr(), B, D, m, form, sP, sM, sK, stream)
    if rc != 0:
        raise RuntimeError(f"symmetric_downdate kernel launch failed: CUDA error {rc}")
    count("b2.calls")
    return out


def _downdate(P: torch.Tensor, M: torch.Tensor,
              keep: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version for tensors on the CPU, the kernel for CUDA ones:
    one launch for P [D,D] and for a batch P [*L,D,D] (its leading dims L
    flattened into one). M and keep may leave out leading dims of P's (one
    shared by every problem). The span "b2" names the call."""
    with span("b2"):
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
                raise ValueError(
                    "P, M and keep of one problem must be contiguous")
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


def symmetric_downdate_rows_ref(P_rows: torch.Tensor, M: torch.Tensor,
                                keep: torch.Tensor | None, r0: int
                                ) -> torch.Tensor:
    """Plain version of rows [r0, r0 + R) of :func:`symmetric_downdate_ref`:
    P_rows [R,D] (those rows of a symmetric P), M [m,D], keep [D] or None;
    returns [R,D] = P_rows o k_rows k^T - (M o k)[:, rows]^T (M o k)."""
    R = P_rows.shape[0]
    if keep is not None:
        P_rows = P_rows * (keep[r0:r0 + R, None] * keep[None, :])
        M = M * keep[None, :]
    cols = M[:, r0:r0 + R]
    if R == 1:
        # a one-row product would go to the BLAS's matrix-vector routine,
        # which sums in another order than the full product's
        return torch.addmm(P_rows.repeat(2, 1), cols.repeat(1, 2).T, M,
                           alpha=-1)[:1]
    return torch.addmm(P_rows, cols.T, M, alpha=-1)


def symmetric_downdate_rows(P_rows: torch.Tensor, M: torch.Tensor,
                            keep: torch.Tensor | None, r0: int
                            ) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`symmetric_downdate_rows_ref`:
    rows [r0, r0 + R) of ``symmetric_downdate(P, M, keep)`` from P's rows
    alone, each element bit for bit the full call's where P is exactly
    symmetric. P_rows [R,D], M [m,D], keep [D] 0/1 or None, contiguous, one
    float type, one CUDA device, 0 <= r0 <= D - R (r0 need not be aligned
    to the tile). The form and its grid come from :func:`rows_config`. The
    plain version for tensors on the CPU. The span "b2" names the call."""
    with span("b2"):
        R, D = P_rows.shape[-2], P_rows.shape[-1]
        if (P_rows.dim() != 2 or M.dim() != 2 or M.shape[-1] != D
                or M.shape[0] < 1 or R < 1 or not 0 <= r0 <= D - R
                or (keep is not None and tuple(keep.shape) != (D,))):
            raise ValueError(f"bad slab: P_rows {tuple(P_rows.shape)}, M "
                             f"{tuple(M.shape)}, r0 {r0}")
        if P_rows.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"no downdate kernel for {P_rows.dtype}")
        for name, t in (("M", M), ("keep", keep)):
            if t is not None and (t.dtype != P_rows.dtype
                                  or t.device != P_rows.device):
                raise ValueError(f"{name} must be a {P_rows.dtype} tensor on "
                                 f"{P_rows.device}")
        if P_rows.device.type == "cpu":
            return symmetric_downdate_rows_ref(P_rows, M, keep, r0)
        if P_rows.device.type != "cuda":
            raise ValueError(f"no downdate kernel for device {P_rows.device}")
        if not (P_rows.is_contiguous() and M.is_contiguous()
                and (keep is None or keep.is_contiguous())):
            raise ValueError("P_rows, M and keep must be contiguous")
        m = M.shape[0]
        out = torch.empty_like(P_rows)
        keep_ptr = None if keep is None else keep.data_ptr()
        form, width, _, split = rows_config(D, R, r0, P_rows.dtype,
                                            sm_count(P_rows.device))
        f64 = P_rows.dtype == torch.float64
        with torch.cuda.device(P_rows.device):
            stream = torch.cuda.current_stream().cuda_stream
            if form == "thin":
                rc = (_LIB_THIN64 if f64 else _LIB_THIN).fn()(
                    P_rows.data_ptr(), M.data_ptr(), keep_ptr,
                    out.data_ptr(), D, m, r0, R, width, stream)
            elif f64:
                rc = _LIB_ROWS64.fn()(
                    P_rows.data_ptr(), M.data_ptr(), keep_ptr,
                    out.data_ptr(), D, m, r0, R, stream)
            else:
                # 128-wide tiles load M from a padded copy whose rows start
                # with the grid origin's zero columns
                cols = -(-(D + grid_origin(r0, width)) // 4) * 4
                scratch = (torch.empty((m, cols), dtype=M.dtype,
                                       device=M.device)
                           if width == 128 else None)
                rc = _LIB_ROWS.fn()(P_rows.data_ptr(), M.data_ptr(), keep_ptr,
                                    None if scratch is None
                                    else scratch.data_ptr(),
                                    out.data_ptr(), D, m, r0, R, width, split,
                                    stream)
        if rc != 0:
            raise RuntimeError(
                "symmetric_downdate_rows kernel launch failed: CUDA error "
                f"{rc}")
        count("b2.rows_calls")
        return out


_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, asked once."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def grid_origin(r0: int, tile: int) -> int:
    """Rows and columns by which a slab's tile grid starts before the
    output: 128-wide (float32) grids start at the slab's first row, so its
    rows fill whole tiles (the scratch copy of M leads with as many zero
    columns); the others at row 0, as the full call's."""
    return -r0 % tile if tile == 128 else 0


def _row_tiles(D: int, R: int, r0: int, tile: int) -> tuple[int, int]:
    """(nr, nt): a slab's row tiles and the tiles across its grid."""
    lp = grid_origin(r0, tile)
    return ((r0 + lp + R - 1) // tile - (r0 + lp) // tile + 1,
            -(-(D + lp) // tile))


def tile_grid(D: int, R: int, r0: int, tile: int) -> int:
    """Thread blocks of a slab in tile x tile tiles: one per pair of its nr
    row tiles with the column tiles outside them, and one per
    lower-triangle tile among its row tiles."""
    nr, nt = _row_tiles(D, R, r0, tile)
    return nr * (nt - nr) + nr * (nr + 1) // 2


def thin_width(D: int, R: int, dtype: torch.dtype, sms: int = H100_SMS) -> int:
    """Columns of a thin block (16 of R rows). float32: the narrowest of 16,
    32, 48 and 64 that puts at most one block on each of ``sms`` SMs, else
    64 (at D = 4621 on an H100: 48 for 13 rows, the fastest there, a second
    block on an SM set the float32 kernel's time; 64 from 17 rows, where
    every width puts more blocks on an SM). float64: 64, the fastest at D =
    4621 (fewer, wider blocks on the FP64 tensor cores)."""
    if dtype == torch.float64:
        return 64
    groups = -(-R // 16)
    return min(64, 16 * max(1, -(-D * groups // (16 * sms))))


def rows_config(D: int, R: int, r0: int, dtype: torch.dtype = torch.float32,
                sms: int = H100_SMS) -> tuple[str, int, int, int]:
    """(form, width, thread blocks, split) of a row slab on a card of
    ``sms`` SMs: ("thin", :func:`thin_width`, ceil(D / width) ceil(R / 16)
    blocks, 0) for at most THIN_MAX_R rows; else ("tiles", :func:`slab_tile`
    (whatever the full call's form: an element's bits do not depend on its
    tile), :func:`tile_grid` + split, split). A float32 grid of 128-wide
    tiles whose last wave would hold at most ``sms`` tiles, one alone on an
    SM, takes those as two half tiles each (split: a float32 element's bits
    do not depend on the tile)."""
    if R <= THIN_MAX_R[dtype]:
        cw = thin_width(D, R, dtype, sms)
        return "thin", cw, -(-D // cw) * -(-R // 16), 0
    tile = slab_tile(D, dtype)
    units = tile_grid(D, R, r0, tile)
    split = 0
    if tile == 128:
        slots = TILE128_BLOCKS_PER_SM * sms
        last = units % slots
        if units > slots and last <= sms:
            nr, nt = _row_tiles(D, R, r0, tile)
            split = min(last, nr * (nt - nr))
    return "tiles", tile, units + split, split


def build():
    """Compile the kernel library (all its entry points) if it is not built
    yet; returns its path."""
    return _LIB.build()
