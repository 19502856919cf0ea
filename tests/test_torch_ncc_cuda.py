"""The hand-written CUDA NCC kernel against its plain PyTorch version, on
the card. Imports no JAX, so it runs where the card is:

    python -m pytest tests/test_torch_ncc_cuda.py -m cuda -q

Without a CUDA device every case skips (the kernel has no CPU mode). The
kernel sums in another order than the plain version, so idx is held to
chip_smoke.compare's tie rule: an idx that differs must score within the
tolerance of the plain maximum. Edge cases whose argmax is fixed by
construction (chip_smoke.ncc_edge_case) hold idx exactly."""

import os
import sys

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch.ops import ncc_cuda

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

# (K, T, S): the CPU tests', the flagship's, the image loop's (bench.py's
# matcher) and the demo defaults' (T = 17, R = 12)
SHAPES = [(8, 9, 7), (5, 17, 25), (3, 9, 11), (768, 15, 15), (48, 15, 21),
          (32, 17, 25)]


def _check(p, t, g, with_neigh, exact_idx):
    """corr (and neighbours) within rtol 1e-4 / atol 1e-5, -inf on the same
    rows, every differing idx a tie within that tolerance; with
    ``exact_idx`` also idx equal to the plain version's."""
    err, agree, ok, nerr = chip_smoke.compare(ncc_cuda, p, t, g, with_neigh)
    assert ok, (err, agree, nerr)
    if exact_idx:
        assert agree == 1.0, agree


@pytest.mark.cuda
@pytest.mark.parametrize("K,T,S", SHAPES)
@pytest.mark.parametrize("with_neigh", [False, True])
def test_torch_ncc_kernel_matches_plain_on_card(K, T, S, with_neigh):
    """The CUDA kernel against its plain version on the same card tensors,
    random data."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(K * 1000 + T * 10 + S)
    p, t, g = chip_smoke.random_case(rng, K, T, S, "cuda")
    _check(p, t, g, with_neigh, exact_idx=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.NCC_EDGE_CASES)
@pytest.mark.parametrize("with_neigh", [False, True])
def test_torch_ncc_kernel_edge_cases_on_card(name, with_neigh):
    """Ragged K = 769, flat windows (raw 0, idx = first gated cell), exact
    ties (idx = the lowest), all-false gates (-inf at 0) and argmaxes on
    window corners (clamped neighbours)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    p, t, g = (torch.as_tensor(a, device="cuda") for a in
               chip_smoke.ncc_edge_case(name, np.random.default_rng(5)))
    _check(p, t, g, with_neigh, exact_idx=name != "ragged")
