"""The symmetric covariance downdate of the PyTorch port (``ops/covariance``)
against the JAX package on the CPU: its plain version against the Pallas
kernel in interpret mode (f32, atol 2e-5, the pin of
tests/test_covariance_kernel.py), against numpy and against the JAX fused
step's masked expression (f64, 1e-12), bitwise symmetry, and the wrapper's
CPU path and argument checks."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.ops.covariance import symmetric_downdate as j_downdate
from surikatoko_tpu_torch.ops import covariance, cuda_build, ncc_cuda

torch.set_num_threads(2)


def _case(rng, D, m, dtype=np.float64):
    A = rng.normal(size=(D, D)) * 0.1
    P = A @ A.T
    M = rng.normal(size=(m, D)) * 0.05
    return P.astype(dtype), M.astype(dtype)


@pytest.mark.parametrize("D,m", [(589, 192), (300, 64), (256, 32)])
def test_torch_downdate_plain_matches_pallas_interpret(rng, D, m):
    P, M = _case(rng, D, m, np.float32)
    want = np.asarray(j_downdate(jnp.asarray(P), jnp.asarray(M),
                                 interpret=True))
    got = covariance.symmetric_downdate_ref(torch.as_tensor(P),
                                            torch.as_tensor(M))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("D,m", [(43, 10), (589, 192)])
def test_torch_downdate_matches_numpy_f64(rng, D, m):
    P, M = _case(rng, D, m)
    got = covariance.symmetric_downdate(torch.as_tensor(P), torch.as_tensor(M))
    np.testing.assert_allclose(got.numpy(), P - M.T @ M, rtol=0, atol=1e-12)
    assert torch.equal(got, got.T)


def test_torch_downdate_keep_matches_jax_fused_expression(rng):
    """The fused step's masked downdate (fused_step.py:191-193) with a 0/1
    keep mask that drops ~10% of the variables."""
    D, m = 211, 48
    P, B = _case(rng, D, m)
    keep = (rng.uniform(size=D) > 0.1).astype(np.float64)
    assert 0 < keep.sum() < D
    Pj, Bj, kj = jnp.asarray(P), jnp.asarray(B), jnp.asarray(keep)
    Bk = Bj * kj[None, :]
    want = np.asarray(Pj * (kj[:, None] * kj[None, :]) - Bk.T @ Bk)
    got = covariance.symmetric_downdate(torch.as_tensor(P), torch.as_tensor(B),
                                        torch.as_tensor(keep))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    dropped = keep == 0
    assert not got.numpy()[dropped].any() and not got.numpy()[:, dropped].any()
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_downdate_bitwise_symmetric(rng, dtype):
    """Symmetric even when P is not and the product's rounding is not: only
    the lower triangle is read and mirrored."""
    D, m = 150, 40
    P = torch.as_tensor(rng.normal(size=(D, D)), dtype=dtype)
    M = torch.as_tensor(rng.normal(size=(m, D)), dtype=dtype)
    keep = torch.as_tensor(rng.uniform(size=D) > 0.05, dtype=dtype)
    for k in (None, keep):
        out = covariance.symmetric_downdate(P, M, k)
        assert out.dtype == dtype
        assert torch.equal(out, out.T)
        assert torch.equal(torch.tril(out),
                           torch.tril(covariance.symmetric_downdate_ref(P, M, k)))


def test_torch_downdate_posterior_stays_psd(rng):
    """EKF-shaped use (tests/test_covariance_kernel.py's case): P - M^T M
    with M = S^-1/2 A keeps PSD."""
    D, m = 128, 16
    A = rng.normal(size=(D, D))
    P = (A @ A.T + 10 * np.eye(D)).astype(np.float32)
    H = rng.normal(size=(m, D)) * 0.1
    S = H @ P.astype(np.float64) @ H.T + np.eye(m)
    L = np.linalg.cholesky(S)
    M = np.linalg.solve(L, H @ P.astype(np.float64)).astype(np.float32)
    out = covariance.symmetric_downdate(torch.as_tensor(P), torch.as_tensor(M))
    evals = np.linalg.eigvalsh(out.numpy().astype(np.float64))
    assert evals.min() > -1e-2


def test_torch_downdate_wrapper_cpu_path_and_checks():
    """CPU tensors take the plain version and never count as a launch; a
    device without a kernel raises (no fallback)."""
    P = torch.eye(5, dtype=torch.float32)
    M = torch.ones((2, 5), dtype=torch.float32)
    before = covariance.LAUNCHES
    out = covariance.symmetric_downdate(P, M)
    assert covariance.LAUNCHES == before
    assert torch.equal(out, torch.eye(5) - 2.0)
    with pytest.raises(ValueError, match="no downdate kernel"):
        covariance.symmetric_downdate(P.to("meta"), M.to("meta"))


def test_torch_downdate_config_covers_every_width():
    """Every D from 1 to 5000 gets a tile edge the kernel has (32 or 128),
    one block per lower-triangle tile, and the edge grows with D, switching
    just past the measured threshold."""
    last = 0
    for D in range(1, 5001):
        tile, blocks = covariance.downdate_config(D)
        assert tile in (32, 128) and tile >= last
        nt = len(range(0, D, tile))
        assert blocks == sum(1 for bi in range(nt) for bj in range(bi + 1))
        last = tile
    assert covariance.downdate_config(covariance.TILE_32_MAX_D)[0] == 32
    assert covariance.downdate_config(covariance.TILE_32_MAX_D + 1)[0] == 128
    with pytest.raises(ValueError):
        covariance.downdate_config(0)


def test_torch_kernel_libraries_keyed_by_their_own_source():
    """Each kernel source builds its own library, named after the source and
    keyed by sha256(source + nvcc flags)[:16] as the NCC library was."""
    flags = " ".join(cuda_build.NVCC_FLAGS).encode()
    for lib, stem in ((ncc_cuda._LIB, "ncc_search"),
                      (covariance._LIB, "symmetric_downdate")):
        tag = hashlib.sha256(lib.source.read_bytes() + flags).hexdigest()[:16]
        assert lib.source.name == f"{stem}.cu"
        assert lib.path() == cuda_build.BUILD_DIR / f"lib{stem}_{tag}.so"
    assert cuda_build.NVCC_FLAGS[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"]
