"""The hand-written CUDA downdate kernel against its plain PyTorch version,
on the card. Imports no JAX, so it runs where the card is:

    python -m pytest tests/test_torch_covariance_cuda.py -m cuda -q

Without a CUDA device every case skips (the kernel has no CPU mode)."""

import pytest
import torch

from surikatoko_tpu_torch.ops import covariance

# (D, m): tests, scenario03, the flagship, and ragged edges (D just past a
# tile edge, m not a multiple of 16)
SHAPES = [(43, 10), (256, 32), (300, 64), (589, 192), (4621, 1536),
          (129, 1), (130, 7), (1000, 33)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(D, m, with_keep, dev):
    g = torch.Generator(device=dev).manual_seed(D * 7 + m)
    A = torch.randn(D, D, generator=g, device=dev)
    P = A @ A.T / D
    P = torch.tril(P) + torch.tril(P, -1).T
    M = 0.05 * torch.randn(m, D, generator=g, device=dev)
    keep = ((torch.rand(D, generator=g, device=dev) > 0.05).float()
            if with_keep else None)
    return P, M, keep


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
    before = covariance.LAUNCHES
    got = covariance.symmetric_downdate(P, M, keep)
    want = covariance.symmetric_downdate_ref(P, M, keep)
    torch.cuda.synchronize()
    assert covariance.LAUNCHES == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("side", [0, 1])
def test_torch_downdate_kernel_at_tile_thresholds(side):
    """Both sides of the tile-edge threshold (32-wide tiles with 4-byte
    loads, then 128-wide with the padded 16-byte loads), with a ragged m."""
    dev = _card()
    D = covariance.TILE_32_MAX_D + side
    P, M, keep = _inputs(D, 48, True, dev)
    got = covariance.symmetric_downdate(P, M, keep)
    want = covariance.symmetric_downdate_ref(P, M, keep)
    torch.cuda.synchronize()
    assert torch.equal(got, got.T)
    assert within_tolerance(got, want, P, M, keep)


@pytest.mark.cuda
def test_torch_downdate_kernel_takes_many_rows():
    """More than 65535 rows of M through the 128-wide tiles' row padding.
    Leading zero rows leave each accumulator at +0 (fmaf(0, 0, +0) = +0), so
    the result equals, bit for bit, the call on the last 40 rows alone,
    which lie past row 65535."""
    dev = _card()
    D = covariance.TILE_32_MAX_D + 1
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
        covariance.symmetric_downdate(P.double(), M.double())      # dtype
