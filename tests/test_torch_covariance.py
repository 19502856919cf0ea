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


@pytest.mark.parametrize("D", [1, 43, 589, 1933, 2317, 4621])
def test_torch_downdate_config_float32_is_the_default(D):
    """The type is a keyword that defaults to float32, whose rule is the
    one D alone gave: 32 up to TILE_32_MAX_D, 128 above."""
    want = 32 if D <= covariance.TILE_32_MAX_D else 128
    nt = -(-D // want)
    assert covariance.downdate_config(D) == (want, nt * (nt + 1) // 2)
    assert covariance.downdate_config(D, torch.float32) == covariance.downdate_config(D)
    assert covariance.downdate_config(D, dtype=torch.float32) == covariance.downdate_config(D)


def test_torch_downdate_config_float64_rule():
    """float64: every D from 1 to 5000 gets the DMMA kernel's 64-wide tile,
    one block per lower-triangle tile."""
    for D in range(1, 5001):
        tile, blocks = covariance.downdate_config(D, torch.float64)
        assert tile == covariance.F64_TILE == 64
        nt = len(range(0, D, tile))
        assert blocks == sum(1 for bi in range(nt) for bj in range(bi + 1))
    assert covariance.downdate_config(1, torch.float64) == (64, 1)
    assert covariance.downdate_config(109, torch.float64) == (64, 2 * 3 // 2)
    assert covariance.downdate_config(589, torch.float64) == (64, 10 * 11 // 2)
    assert covariance.downdate_config(4621, torch.float64) == (64, 73 * 74 // 2)
    with pytest.raises(ValueError):
        covariance.downdate_config(0, torch.float64)


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


# (D, m, r0, R): row slabs whose r0 and r0 + R lie off the tile edges (13 +
# 6 L rank), a slab of the camera rows, one of the whole matrix, one row;
# then the thin kernel's shapes: the camera rows at r0 = 0 and at landmark
# 5's rows, 16, 17 and 32 rows, m ragged against 16 and 32
SLABS = [(43, 10, 13, 24), (43, 10, 0, 43), (109, 32, 13 + 48, 48),
         (300, 64, 7, 13), (589, 192, 13 + 96, 96), (130, 7, 129, 1)]
THIN_SLABS = [(109, 47, 0, 13), (109, 33, 13 + 6 * 5, 13), (300, 17, 7, 1),
              (300, 47, 0, 16), (589, 33, 7, 17), (300, 50, 21, 32)]


@pytest.mark.parametrize("D,m,r0,R", SLABS + THIN_SLABS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_downdate_rows_plain_equals_full_rows(rng, D, m, r0, R, dtype,
                                                     with_keep):
    """The plain row slab is bit for bit the matching rows of the plain
    full downdate for a symmetric P, and the wrapper takes it on the CPU."""
    P, M = _case(rng, D, m)
    P = torch.as_tensor(P, dtype=dtype)
    P = torch.tril(P) + torch.tril(P, -1).T
    M = torch.as_tensor(M, dtype=dtype)
    keep = (torch.as_tensor(rng.uniform(size=D) > 0.1, dtype=dtype)
            if with_keep else None)
    full = covariance.symmetric_downdate_ref(P, M, keep)
    Pr = P[r0:r0 + R].contiguous()
    assert torch.equal(covariance.symmetric_downdate_rows_ref(Pr, M, keep, r0),
                       full[r0:r0 + R])
    before = covariance.ROWS_LAUNCHES
    assert torch.equal(covariance.symmetric_downdate_rows(Pr, M, keep, r0),
                       full[r0:r0 + R])
    assert covariance.ROWS_LAUNCHES == before


@pytest.mark.parametrize("D,m,r0,R", THIN_SLABS)
def test_torch_downdate_rows_plain_matches_pallas_interpret(rng, D, m, r0, R):
    """The plain slab at the thin shapes against the rows of the JAX
    kernel's output in interpret mode (f32, atol 2e-5, as the full call's
    pin)."""
    P, M = _case(rng, D, m, np.float32)
    P = np.tril(P) + np.tril(P, -1).T
    want = np.asarray(j_downdate(jnp.asarray(P), jnp.asarray(M),
                                 interpret=True))[r0:r0 + R]
    got = covariance.symmetric_downdate_rows_ref(
        torch.as_tensor(P[r0:r0 + R]).contiguous(), torch.as_tensor(M), None,
        r0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_torch_downdate_rows_checks():
    P = torch.eye(20, dtype=torch.float64)
    M = torch.ones((3, 20), dtype=torch.float64)
    with pytest.raises(ValueError, match="bad slab"):
        covariance.symmetric_downdate_rows(P[5:15], M, None, 11)
    with pytest.raises(ValueError, match="bad slab"):
        covariance.symmetric_downdate_rows(P[5:15], M[:, :19], None, 5)
    with pytest.raises(ValueError, match="must be a"):
        covariance.symmetric_downdate_rows(P[5:15], M.float(), None, 5)
    with pytest.raises(ValueError, match="no downdate kernel"):
        covariance.symmetric_downdate_rows(P[5:15].half(), M.half(), None, 5)


def test_torch_downdate_rows_config():
    """A slab's form and grid on an H100 (132 SMs). Up to THIN_MAX_R rows
    (128 float32, 64 float64) the thin kernel: ceil(D / width) column
    blocks for each 16 rows. Above,
    the full call's tile edge: its row tiles (r0 off the tile edge adds one
    in float64, whose grid starts at row 0; a float32 128-wide grid starts
    at r0) times the column tiles outside them, plus each pair of its row
    tiles once, and in float32 a last wave of at most 132 tiles split in
    halves; a float64 slab of every row is the full call's grid."""
    f64 = torch.float64
    # one rank of one at K=768: float64 the full call's 73 x 74 / 2 tiles;
    # float32 36 aligned row tiles, 36 pairs x 1 column tile + 36 x 37 / 2
    assert covariance.rows_config(4621, 4608, 13, f64) == (
        "tiles", 64, 73 * 74 // 2, 0)
    assert covariance.rows_config(4621, 4608, 13) == (
        "tiles", 128, 36 * 1 + 36 * 37 // 2, 0)
    # rank 1 of four: float64 19 row tiles; float32 9 aligned ones, 297
    # tiles, 264 in two blocks an SM and the last 33 in halves
    assert covariance.rows_config(4621, 1152, 13 + 1152, f64) == (
        "tiles", 64, 19 * 54 + 19 * 20 // 2, 0)
    assert covariance.rows_config(4621, 1152, 13 + 1152) == (
        "tiles", 128, 9 * 28 + 9 * 10 // 2 + 33, 33)
    # the two ranks of two: 18 aligned row tiles, 513 tiles (a last wave
    # of 249: not split)
    for r0 in (13, 13 + 2304):
        assert covariance.rows_config(4621, 2304, r0) == (
            "tiles", 128, 18 * 19 + 18 * 19 // 2, 0)
    # the camera rows and other thin slabs
    # (float32: the narrowest width that gives at most one block an SM,
    # else 64)
    assert covariance.rows_config(4621, 13, 0) == ("thin", 48, 97, 0)
    assert covariance.rows_config(4621, 13, 0, f64) == ("thin", 64, 73, 0)
    assert covariance.rows_config(4621, 17, 0) == ("thin", 64, 73 * 2, 0)
    assert covariance.rows_config(4621, 13, 0, sms=66) == ("thin", 64, 73, 0)
    assert covariance.rows_config(589, 96, 109) == ("thin", 32, 19 * 6, 0)
    assert covariance.rows_config(589, 13, 43) == ("thin", 16, 37, 0)
    assert covariance.rows_config(589, 96, 109, f64) == (
        "tiles", 64, 3 * 7 + 3 * 4 // 2, 0)
    assert covariance.rows_config(589, 13, 43, f64) == ("thin", 64, 10, 0)
    # 32-wide tiles below TILE_32_MAX_D, from row 0 as the full call's
    assert covariance.rows_config(589, 196, 109) == (
        "tiles", 32, 7 * 12 + 7 * 8 // 2, 0)
    assert covariance.rows_config(589, 196, 109, f64) == (
        "tiles", 64, 4 * 6 + 4 * 5 // 2, 0)
