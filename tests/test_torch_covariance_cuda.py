"""The hand-written CUDA downdate kernel against its plain PyTorch version,
on the card, in float32 and float64, and the scan runner in float64 on the
card against the CPU. Imports no JAX, so it runs where the card is:

    python -m pytest tests/test_torch_covariance_cuda.py -m cuda -q

Without a CUDA device every case skips (the kernel has no CPU mode)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch.ops import covariance
from surikatoko_tpu_torch.utils.profiling import counts

# (D, m): tests, scenario03, the flagship, and ragged edges (D just past a
# tile edge, m not a multiple of 16)
SHAPES = [(43, 10), (256, 32), (300, 64), (589, 192), (4621, 1536),
          (129, 1), (130, 7), (1000, 33)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(D, m, with_keep, dev, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(D * 7 + m)
    A = torch.randn(D, D, generator=g, device=dev, dtype=dtype)
    P = A @ A.T / D
    P = torch.tril(P) + torch.tril(P, -1).T
    M = 0.05 * torch.randn(m, D, generator=g, device=dev, dtype=dtype)
    keep = ((torch.rand(D, generator=g, device=dev, dtype=dtype) > 0.05).to(dtype)
            if with_keep else None)
    return P, M, keep


def fmaf_chain_rows(P, M, keep, r0, R):
    """Rows r0 .. r0 + R - 1 of the float32 kernel's arithmetic, emulated
    exactly: per output one f32 accumulator from +0 and acc = fmaf(M_as,
    M_ac, acc) for a = 0 .. m-1, then (P_sc - acc) k_s k_c. The product is
    exact in float64; the sum p + acc is taken in float64 with its rounding
    error (two-sum), and where the float64 sum falls exactly halfway
    between two floats the error decides the side, so each step is the one
    rounding of fmaf (rounding the float64 sum to float32 would round twice,
    which millions of outputs do hit)."""
    Md = M.double()
    acc = torch.zeros((R, M.shape[1]), dtype=torch.float32, device=M.device)
    inf = torch.full_like(acc, float("inf"))
    for a in range(M.shape[0]):
        p = Md[a, r0:r0 + R, None] * Md[a][None, :]
        q = acc.double()
        s = p + q
        b = s - p
        e = (p - (s - b)) + (q - b)
        r = s.float()
        d = s - r.double()
        n = torch.nextafter(r, torch.where(d > 0, inf, -inf))
        half = 2 * d == n.double() - r.double()
        acc = torch.where(half & (d != 0) & (e != 0) & ((e > 0) == (d > 0)),
                          n, r)
    v = P[r0:r0 + R] - acc
    if keep is not None:
        v = v * (keep[r0:r0 + R, None] * keep[None, :])
    return v


def fmaf_chain(P, M, keep):
    """The float32 kernel's arithmetic, emulated exactly (fmaf_chain_rows
    over every row): per output one f32 accumulator from +0, acc =
    fmaf(M_ai, M_aj, acc) for a = 0 .. m-1, then (P_ij - acc) k_i k_j on
    the lower triangle, mirrored."""
    v = fmaf_chain_rows(P, M, keep, 0, P.shape[0])
    return torch.tril(v) + torch.tril(v, -1).T


def within_tolerance(got, want, P, M, keep):
    """|kernel - plain| <= 1e-5 (|P| o |kk^T| + |M o k|^T |M o k|) + 1e-30:
    the scale the summands set; f32 over m terms rounds to ~sqrt(m) 6e-8."""
    k = torch.ones(P.shape[0], device=P.device) if keep is None else keep
    Mk = (M * k[None, :]).abs()
    bound = 1e-5 * (P.abs() * (k[:, None] * k[None, :]) + Mk.T @ Mk) + 1e-30
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D,m", SHAPES)
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_downdate_kernel_matches_plain_on_card(D, m, with_keep):
    dev = _card()
    P, M, keep = _inputs(D, m, with_keep, dev)
    before = counts().get("b2.calls", 0)
    got = covariance.symmetric_downdate(P, M, keep)
    want = covariance.symmetric_downdate_ref(P, M, keep)
    torch.cuda.synchronize()
    assert counts().get("b2.calls", 0) == before + 1
    assert torch.equal(got, got.T)
    assert within_tolerance(got, want, P, M, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_downdate_kernel_repeats_bitwise(with_keep):
    """No split-K and no atomics: two launches on the same inputs agree bit
    for bit, at the flagship shape."""
    dev = _card()
    P, M, keep = _inputs(4621, 1536, with_keep, dev)
    first = covariance.symmetric_downdate(P, M, keep)
    assert torch.equal(first, covariance.symmetric_downdate(P, M, keep))


# the last D of each float32 form of one problem on 132 SMs and the form
# after it: Small16 | Small32 | Tile32 | Batch32 | Tile128 (128-wide with
# the padded 16-byte loads, from PR 4's edge on)
FORM_EDGES = [(352, "Small16", "Small32"), (864, "Small32", "Tile32"),
              (1440, "Tile32", "Batch32"),
              (covariance.TILE_32_MAX_D, "Batch32", "Tile128")]


@pytest.mark.cuda
@pytest.mark.parametrize("edge,before,after", FORM_EDGES)
@pytest.mark.parametrize("side", [0, 1])
def test_torch_downdate_kernel_at_tile_thresholds(edge, before, after, side):
    """Both sides of each edge of the float32 rule for one problem, with a
    ragged m: within tolerance of the plain version, bitwise symmetric, and
    the emulated fmaf chain bit for bit."""
    dev = _card()
    D = edge + side
    name = covariance.F32_FORMS[covariance.f32_form(
        D, 1, covariance.sm_count(dev))].name
    if covariance.sm_count(dev) == covariance.H100_SMS:
        assert name == (after if side else before)
    P, M, keep = _inputs(D, 48, True, dev)
    got = covariance.symmetric_downdate(P, M, keep)
    want = covariance.symmetric_downdate_ref(P, M, keep)
    torch.cuda.synchronize()
    assert torch.equal(got, got.T)
    assert within_tolerance(got, want, P, M, keep)
    assert torch.equal(got, fmaf_chain(P, M, keep))


@pytest.mark.cuda
def test_torch_downdate_kernel_takes_many_rows():
    """More than 65535 rows of M through the 128-wide tiles' row padding.
    Leading zero rows leave each accumulator at +0 (fmaf(0, 0, +0) = +0), so
    the result equals, bit for bit, the call on the last 40 rows alone,
    which lie past row 65535."""
    dev = _card()
    D = covariance.TILE_32_MAX_D + 1
    assert covariance.f32_form(D) == covariance.TILE128
    P, tail, keep = _inputs(D, 40, True, dev)
    M = torch.zeros((70_000, D), device=dev)
    M[-40:] = tail
    got = covariance.symmetric_downdate(P, M, keep)
    short = covariance.symmetric_downdate(P, tail, keep)
    want = covariance.symmetric_downdate_ref(P, tail, keep)
    torch.cuda.synchronize()
    assert torch.equal(got, short)
    assert within_tolerance(got, want, P, tail, keep)


@pytest.mark.cuda
def test_torch_downdate_kernel_rejects_what_it_cannot_take():
    dev = _card()
    P, M, _ = _inputs(64, 8, False, dev)
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P, M[:, :-1])                # width
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P, M.T.contiguous().T)       # layout
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P.half(), M.half())          # dtype
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P.double(), M)               # mixed


def f64_checked(P, M, keep):
    """Two float64 wrapper calls against the plain version: both counted,
    bitwise symmetric, bitwise equal to each other, finite, and within 1e-12
    of the plain version in the relative Frobenius norm."""
    before = counts().get("b2.calls", 0)
    got = covariance.symmetric_downdate(P, M, keep)
    again = covariance.symmetric_downdate(P, M, keep)
    want = covariance.symmetric_downdate_ref(P, M, keep)
    torch.cuda.synchronize()
    assert counts().get("b2.calls", 0) == before + 2
    assert got.dtype == torch.float64
    assert torch.equal(got, got.T) and torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("D,m", SHAPES)
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_downdate_kernel_f64_matches_plain_on_card(D, m, with_keep):
    """The float64 entry point at every shape (f64_checked)."""
    dev = _card()
    f64_checked(*_inputs(D, m, with_keep, dev, torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 63, 64, 65, 127, 128, 129])
def test_torch_downdate_kernel_f64_at_tile_edges(D):
    """The DMMA kernel's 64-wide tile edges +-1, and D below one MMA tile,
    with a ragged m: one diagonal tile, or a ragged last row of tiles."""
    dev = _card()
    assert covariance.downdate_config(D, torch.float64)[0] == 64
    f64_checked(*_inputs(D, 48, True, dev, torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [43, 1000, 4621])
@pytest.mark.parametrize("m", [1, 3, 7, 17, 33])
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_downdate_kernel_f64_ragged_m(D, m, with_keep):
    """m short of the 16-row panel (zero-filled rows) and past it, D inside
    one tile (43), past a tile edge (1000) and at the flagship's 4621."""
    dev = _card()
    f64_checked(*_inputs(D, m, with_keep, dev, torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [43, 300, 2317])
def test_torch_downdate_kernel_f64_tall_m(D):
    """m = 2000 rows, many panels through the cp.async ring, at a small D
    and at a large one."""
    dev = _card()
    f64_checked(*_inputs(D, 2000, True, dev, torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_downdate_kernel_f64_repeats_bitwise(with_keep):
    """No split-K and no atomics in float64 either: two launches agree bit
    for bit at a small shape and at the flagship's, and both run on the FP64
    tensor cores (a kernel named for DMMA shows in the profile)."""
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    for D, m in ((43, 10), (4621, 1536)):
        P, M, keep = _inputs(D, m, with_keep, dev, torch.float64)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            first = covariance.symmetric_downdate(P, M, keep)
            torch.cuda.synchronize()
        assert torch.equal(first, covariance.symmetric_downdate(P, M, keep))
        names = {e.name for e in prof.events()}
        assert any("downdate_kernel_dmma" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("D,m,B", [(43, 10, 1), (129, 1, 1), (130, 7, 1),
                                   (300, 64, 1), (2000, 17, 1),
                                   (352, 33, 1), (353, 33, 1), (589, 192, 1),
                                   (864, 20, 1), (865, 20, 1), (1933, 9, 1),
                                   (1934, 9, 1), (2318, 9, 1),
                                   (589, 47, 3), (301, 33, 10),
                                   (589, 33, 12), (1000, 17, 8)])
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_downdate_kernel_f32_is_its_fmaf_chain(D, m, B, with_keep):
    """The float32 kernel keeps its summation order bit for bit in every
    form the rule picks (one problem: Small16 to D = 352, Small32 to 864,
    Tile32, Batch32 from 1441, Tile128 past 1933; batches of 3 x 589 and
    10 x 301 in Tile32, 12 x 589 and 8 x 1000 in Batch32): each problem
    equals the emulated fmaf chain."""
    dev = _card()
    if B == 1:
        P, M, keep = _inputs(D, m, with_keep, dev)
        got = covariance.symmetric_downdate(P, M, keep)
        assert torch.equal(got, fmaf_chain(P, M, keep))
        return
    cases = [_inputs(D, m + b, with_keep, dev) for b in range(B)]
    Ms = torch.stack([c[1][:m] for c in cases])
    P = torch.stack([c[0] for c in cases])
    keep = None if not with_keep else torch.stack([c[2] for c in cases])
    got = covariance.symmetric_downdate(P, Ms, keep)
    for b in range(B):
        assert torch.equal(got[b], fmaf_chain(
            P[b], Ms[b], None if keep is None else keep[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,m", [(1, 43, 10), (1, 301, 33), (1, 589, 192),
                                   (3, 130, 7), (2, 1000, 40), (4, 589, 17)])
def test_torch_downdate_forms_equal_bitwise(B, D, m):
    """Every float32 form of the library's entry point, launched directly,
    gives the same bits as every other and as the emulated fmaf chain: an
    element's bits do not depend on the form that computes it."""
    from surikatoko_tpu_torch.ops.cuda_build import KernelLibrary
    dev = _card()
    fn = KernelLibrary(covariance._LIB.source.name,
                       "symmetric_downdate_f32_batched",
                       covariance._LIB.argtypes).fn()
    cases = [_inputs(D, m, True, dev) for _ in range(B)]
    P = torch.stack([c[0] for c in cases])
    M = torch.stack([c[1] * (b + 1) for b, c in enumerate(cases)])
    keep = torch.stack([c[2] for c in cases])
    outs = []
    for form, f in enumerate(covariance.F32_FORMS):
        out = torch.empty_like(P)
        scratch = (torch.empty((B, m, -(-D // 4) * 4), device=dev)
                   if f.padded else None)
        rc = fn(P.data_ptr(), M.data_ptr(), keep.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                out.data_ptr(), B, D, m, form, D * D, m * D, D,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, (f.name, rc)
        outs.append(out)
    torch.cuda.synchronize()
    for f, out in zip(covariance.F32_FORMS, outs):
        assert torch.equal(out, outs[0]), f.name
    for b in range(B):
        assert torch.equal(outs[0][b], fmaf_chain(P[b], M[b], keep[b]))
    bad = fn(P.data_ptr(), M.data_ptr(), keep.data_ptr(), None,
             outs[0].data_ptr(), B, D, m, len(covariance.F32_FORMS),
             D * D, m * D, D, torch.cuda.current_stream().cuda_stream)
    assert bad != 0     # no form past the table


@pytest.mark.cuda
def test_torch_scan_runner_f64_on_card_matches_cpu():
    """make_scan_runner(1) in float64 on the card, 30 frames of scenario03
    (K=96), against the same run on the CPU: camera positions within 1e-9."""
    from surikatoko_tpu_torch import config
    from surikatoko_tpu_torch.geom import camera
    from surikatoko_tpu_torch.models.monoslam import init_state, make_params
    from surikatoko_tpu_torch.world.device_runner import (
        build_oscillating_scenario, init_with_gt_landmarks, make_scan_runner)
    dev = _card()
    config.set_full_precision()
    rng = np.random.default_rng(3)
    noise0, noise = rng.standard_normal((96, 2)), rng.standard_normal((30, 96, 2))
    pos = {}
    for d in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=d)
        cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                     (0.01, 0.01), dtype=torch.float64, device=d)
        params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                             process_noise_ang_veloc_std=0.01,
                             dtype=torch.float64, device=d)
        sc = build_oscillating_scenario(96, dtype=torch.float64, device=d)
        st = init_with_gt_landmarks(params, sc, init_state(
            96, dtype=torch.float64, device=d), t(noise0))
        before = counts().get("b2.calls", 0)
        out = make_scan_runner(params, 1)(st, sc, range(1, 31), t(noise))
        if d.type == "cuda":
            assert counts().get("b2.calls", 0) == before + 30
            assert torch.equal(out[0].P, out[0].P.T)
        pos[d.type] = out[3].cpu()
    assert float((pos["cuda"] - pos["cpu"]).abs().max()) <= 1e-9


# (D, m, r0, R) of the row slabs: one rank at K=768, rank 1 of four, the
# camera rows, f32's 32- and 128-wide tiles off their edges, ragged m; the
# two ranks of two at K=768; thin slabs (one row, the camera rows at r0 = 0
# and at landmark 5's rows, 16, 17 and 32 rows, r0 off the 16-row edge, m
# ragged against 16 and 32)
SLABS = [(4621, 1536, 13, 4608), (4621, 1536, 13 + 1152, 1152),
         (4621, 1536, 0, 13), (589, 192, 13 + 96, 96), (2317, 772, 613, 600),
         (130, 7, 5, 100), (43, 10, 0, 43),
         (4621, 1536, 13, 2304), (4621, 1536, 13 + 2304, 2304),
         (4621, 1536, 13 + 6 * 5, 13), (589, 47, 13 + 6 * 5, 13),
         (589, 193, 300, 1), (589, 33, 0, 16), (589, 17, 7, 17),
         (1000, 50, 21, 32), (130, 7, 0, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,m,r0,R", SLABS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_downdate_rows_kernel_equals_full_kernel(D, m, r0, R, dtype,
                                                       with_keep):
    """The row-slab kernel writes, bit for bit, the full kernel's rows
    r0 .. r0 + R - 1 (in float32 the same fmaf chain an element, emulated
    by fmaf_chain_rows; in float64 the same DMMAs), one launch on its own
    count, and repeats."""
    dev = _card()
    P, M, keep = _inputs(D, m, with_keep, dev, dtype)
    Pr = P[r0:r0 + R].contiguous()
    full = covariance.symmetric_downdate(P, M, keep)
    before = counts().get("b2.rows_calls", 0)
    got = covariance.symmetric_downdate_rows(Pr, M, keep, r0)
    again = covariance.symmetric_downdate_rows(Pr, M, keep, r0)
    torch.cuda.synchronize()
    assert counts().get("b2.rows_calls", 0) == before + 2
    assert torch.equal(got, full[r0:r0 + R])
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert torch.equal(got, fmaf_chain_rows(P, M, keep, r0, R))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_downdate_rows_thin_is_one_launch(dtype):
    """The camera rows' slab takes the thin kernel: one device launch, no
    row padding copy. Profiled in a process of its own (after another
    profile in the same process the profiler may record no device event)."""
    _card()
    assert covariance.rows_config(4621, 13, 0, dtype)[0] == "thin"
    code = f"""
import torch
from surikatoko_tpu_torch.ops import covariance
from surikatoko_tpu_torch.utils.profiling import device_profile
dev = torch.device("cuda", 0)
P = torch.eye(4621, device=dev, dtype={dtype})
M = torch.rand(1536, 4621, device=dev, dtype={dtype})
keep = torch.ones(4621, device=dev, dtype={dtype})
Pr = P[:13].contiguous()
covariance.symmetric_downdate_rows(Pr, M, keep, 0)
kernels = device_profile(
    lambda: covariance.symmetric_downdate_rows(Pr, M, keep, 0))[3]
print(sorted((k, v[1]) for k, v in kernels.items()))
"""
    root = Path(__file__).resolve().parent.parent
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=root, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(root)})
    assert done.returncode == 0, done.stderr
    kernels = ast.literal_eval(done.stdout.strip().splitlines()[-1])
    assert len(kernels) == 1 and "thin_kernel" in kernels[0][0], kernels
    assert kernels[0][1] == 1, kernels
