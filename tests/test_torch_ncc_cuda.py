"""The hand-written CUDA NCC kernel against its plain PyTorch version, on
the card. Imports no JAX, so it runs where the card is:

    python -m pytest tests/test_torch_ncc_cuda.py -m cuda -q

Without a CUDA device every case skips (the kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch.ops import ncc_cuda

SHAPES = [(8, 9, 7), (5, 17, 25), (3, 9, 11), (768, 15, 15)]   # (K, T, S)


@pytest.mark.cuda
@pytest.mark.parametrize("K,T,S", SHAPES)
@pytest.mark.parametrize("with_neigh", [False, True])
def test_torch_ncc_kernel_matches_plain_on_card(K, T, S, with_neigh):
    """The CUDA kernel against its plain version on the same card tensors:
    idx exact, corr within rtol 1e-4 / atol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(K * 1000 + T * 10 + S)
    P = S + T - 1
    gate = rng.uniform(size=(K, S, S)) < 0.7
    gate[:, S // 2, S // 2] = True
    p, t, g = (torch.as_tensor(a, device="cuda") for a in (
        rng.uniform(0, 255, size=(K, P, P)).astype(np.float32),
        rng.uniform(0, 255, size=(K, T, T)).astype(np.float32), gate))
    got = ncc_cuda.ncc_surface_argmax(p, t, g, with_neigh)
    want = ncc_cuda.ncc_surface_argmax_ref(p, t, g, with_neigh)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    if with_neigh:
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5)
