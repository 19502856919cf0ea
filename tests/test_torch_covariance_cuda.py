"""The hand-written CUDA downdate kernel against its plain PyTorch version,
on the card. Imports no JAX, so it runs where the card is:

    python -m pytest tests/test_torch_covariance_cuda.py -m cuda -q

Without a CUDA device every case skips (the kernel has no CPU mode)."""

import pytest
import torch

from surikatoko_tpu_torch.ops import covariance

SHAPES = [(43, 10), (256, 32), (300, 64), (589, 192), (4621, 1536)]   # (D, m)


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
def test_torch_downdate_kernel_rejects_what_it_cannot_take():
    dev = _card()
    P, M, _ = _inputs(64, 8, False, dev)
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P, M[:, :-1])                # width
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P, M.T.contiguous().T)       # layout
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P.double(), M.double())      # dtype
