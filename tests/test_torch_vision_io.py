"""The port's ellipse gate, single-window ZNCC, PNM pictures and frame
loader against the JAX package, on the CPU.

Tolerances: ellipses in float64 within 1e-12 (R compared through
R diag(a^2) R^T, since either package's eigh may flip an eigenvector's
sign; det R = +1 exactly as a rotation), quantiles within 1e-15,
``corr_coeff_single`` within 1e-12 in float64; pictures and frames byte for
byte. The port builds ``native/frameloader.cpp`` into its own ``_build/``
and leaves ``native/`` as it found it."""

import hashlib
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import ellipse as jell
from surikatoko_tpu.io import frame_loader as jfl
from surikatoko_tpu.vision import picture as jpic
from surikatoko_tpu.vision import templ_match as jtm
from surikatoko_tpu_torch.geom import ellipse as tell
from surikatoko_tpu_torch.io import frame_loader as tfl
from surikatoko_tpu_torch.ops import cuda_build
from surikatoko_tpu_torch.vision import picture as tpic
from surikatoko_tpu_torch.vision import templ_match as ttm

torch.set_num_threads(2)
FRAMES_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "frames")
NATIVE_SO = os.path.join(os.path.dirname(__file__), "..", "native",
                         "libframeloader.so")
TOL = 1e-12


def _rot(a):
    return np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])


COVS = {"axis_aligned": np.diag([4.0, 1.0]),
        "rotated": _rot(0.7) @ np.diag([9.0, 1.0]) @ _rot(0.7).T,
        "round": np.eye(2) * 2.5,
        "batch": np.stack([_rot(a) @ np.diag([5.0 + a, 0.5]) @ _rot(a).T
                           for a in (-1.2, 0.1, 2.0)])}


@pytest.mark.parametrize("name", sorted(COVS))
def test_torch_ellipse_from_covariance_matches_jax(name):
    cov = COVS[name]
    center = np.zeros(cov.shape[:-1]) + np.array([10.0, 20.0])
    want = jell.ellipse_from_covariance(jnp.asarray(cov), jnp.asarray(center), 0.95)
    got = tell.ellipse_from_covariance(torch.as_tensor(cov),
                                       torch.as_tensor(center), 0.95)
    np.testing.assert_allclose(got.semi_axes.numpy(), np.asarray(want.semi_axes),
                               rtol=TOL, atol=0)

    def form(R, a):
        return R @ (a[..., :, None] ** 2 * np.swapaxes(R, -1, -2))

    np.testing.assert_allclose(form(got.R.numpy(), got.semi_axes.numpy()),
                               form(np.asarray(want.R), np.asarray(want.semi_axes)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.linalg.det(got.R.numpy()), 1.0, atol=TOL)
    np.testing.assert_allclose(tell.ellipse_bounds(got).numpy(),
                               np.asarray(jell.ellipse_bounds(want)),
                               rtol=TOL, atol=TOL)


def test_torch_ellipse_axis_aligned_and_principal_axes():
    """tests/test_rect_ellipse.py:51-70 on the port."""
    chi2 = float(tell.chi_square_quantile_2dof(0.95))
    e = tell.ellipse_from_covariance(torch.diag(torch.tensor([4.0, 1.0],
                                                             dtype=torch.float64)),
                                     torch.zeros(2, dtype=torch.float64), 0.95)
    np.testing.assert_allclose(sorted(e.semi_axes.numpy(), reverse=True),
                               [np.sqrt(4 * chi2), np.sqrt(chi2)], atol=1e-9)
    np.testing.assert_allclose(abs(e.R.numpy()), np.eye(2), atol=1e-9)
    e = tell.ellipse_from_covariance(torch.as_tensor(COVS["rotated"]),
                                     torch.zeros(2, dtype=torch.float64), 0.95)
    np.testing.assert_allclose(abs(np.dot(e.R.numpy()[:, 0], _rot(0.7)[:, 0])),
                               1.0, atol=1e-9)


def test_torch_chi_square_quantiles_match_jax():
    """tests/test_rect_ellipse.py:73-77, and both quantiles against JAX's
    over the confidence range, through every branch of the 3-dof normal
    quantile."""
    np.testing.assert_allclose(float(tell.chi_square_quantile_2dof(0.95)),
                               5.9915, atol=1e-3)
    np.testing.assert_allclose(float(tell.chi_square_quantile_3dof(0.95)),
                               7.8147, rtol=1e-2)
    p = np.array([1e-6, 0.01, 0.02425, 0.3, 0.5, 0.9, 0.95, 0.99, 0.999999])
    for t, j in ((tell.chi_square_quantile_2dof, jell.chi_square_quantile_2dof),
                 (tell.chi_square_quantile_3dof, jell.chi_square_quantile_3dof)):
        np.testing.assert_allclose(t(torch.as_tensor(p)).numpy(),
                                   np.asarray(j(jnp.asarray(p))), rtol=1e-15,
                                   atol=0)


def test_torch_ellipsoid_matches_jax():
    """tests/test_rect_ellipse.py:80-84: the extractable test, and the 3-D
    ellipsoid against JAX's."""
    good = torch.diag(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    bad = torch.diag(torch.tensor([1.0, -0.1, 3.0], dtype=torch.float64))
    assert bool(tell.is_ellipsoid_extractable(good))
    assert not bool(tell.is_ellipsoid_extractable(bad))
    both = torch.stack([good, bad])
    np.testing.assert_array_equal(
        tell.is_ellipsoid_extractable(both).numpy(),
        np.asarray(jell.is_ellipsoid_extractable(jnp.asarray(both.numpy()))))
    rng = np.random.default_rng(4)
    A = rng.normal(size=(3, 3))
    cov = A @ A.T + 0.1 * np.eye(3)
    want = jell.ellipsoid_from_covariance(jnp.asarray(cov), jnp.zeros(3), 0.9)
    got = tell.ellipsoid_from_covariance(torch.as_tensor(cov),
                                         torch.zeros(3, dtype=torch.float64), 0.9)
    np.testing.assert_allclose(got.semi_axes.numpy(), np.asarray(want.semi_axes),
                               rtol=TOL)
    Rg, Rw = got.R.numpy(), np.asarray(want.R)
    np.testing.assert_allclose(Rg @ np.diag(got.semi_axes.numpy() ** 2) @ Rg.T,
                               Rw @ np.diag(np.asarray(want.semi_axes) ** 2) @ Rw.T,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.linalg.det(Rg), 1.0, atol=TOL)


def test_torch_ellipse_bounds():
    """tests/test_rect_ellipse.py:87-92 on the port."""
    e = tell.ellipse_from_covariance(
        torch.diag(torch.tensor([4.0, 1.0], dtype=torch.float64)),
        torch.tensor([10.0, 20.0], dtype=torch.float64), 0.95)
    chi2 = float(tell.chi_square_quantile_2dof(0.95))
    np.testing.assert_allclose(
        tell.ellipse_bounds(e).numpy(),
        [10 - 2 * np.sqrt(chi2), 20 - np.sqrt(chi2), 4 * np.sqrt(chi2),
         2 * np.sqrt(chi2)], atol=1e-9)


def test_torch_corr_coeff_single_matches_jax(rng):
    """tests/test_vision.py:37-50 (identical window 1, flat window 0) and
    random windows against JAX, float64."""
    T = 9
    templ = rng.uniform(0, 255, size=(T, T))
    t = torch.as_tensor(templ)
    np.testing.assert_allclose(float(ttm.corr_coeff_single(t, t)), 1.0, atol=1e-9)
    flat = torch.full((T, T), 100.0, dtype=torch.float64)
    assert float(ttm.corr_coeff_single(flat, t)) == 0.0
    for _ in range(4):
        roi = rng.uniform(0, 255, size=(T, T))
        np.testing.assert_allclose(
            float(ttm.corr_coeff_single(torch.as_tensor(roi), t)),
            float(jtm.corr_coeff_single(jnp.asarray(roi), jnp.asarray(templ))),
            rtol=0, atol=TOL)


def test_torch_picture_round_trip(tmp_path):
    """save_picture -> load_picture recovers the bytes (P5 gray, P6 color),
    and the port's files are byte for byte the JAX package's."""
    gen = np.random.default_rng(0)
    gray = gen.integers(0, 256, size=(24, 32), dtype=np.uint8)
    rgb = gen.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
    for name, img in (("g.pgm", gray), ("c.ppm", rgb)):
        tpic.save_picture(str(tmp_path / name), img)
        jpic.save_picture(str(tmp_path / ("j" + name)), img)
        assert ((tmp_path / name).read_bytes()
                == (tmp_path / ("j" + name)).read_bytes())
    np.testing.assert_array_equal(tpic.load_picture(str(tmp_path / "g.pgm")).gray,
                                  gray)
    pic = tpic.load_picture(str(tmp_path / "c.ppm"))
    np.testing.assert_array_equal(pic.bgr_debug, rgb[..., ::-1])
    np.testing.assert_array_equal(
        pic.gray, jpic.load_picture(str(tmp_path / "c.ppm")).gray)
    assert pic.size == (32, 24)
    with pytest.raises(ValueError):
        tpic.save_picture(str(tmp_path / "bad.pgm"), np.zeros((2, 2, 2)))
    assert tpic.list_image_dir(str(tmp_path)) == jpic.list_image_dir(str(tmp_path))


@pytest.mark.parametrize("native", [True, False])
def test_torch_frame_loader_matches_reference(monkeypatch, native):
    """Every frame of tests/fixtures/frames (P5, P6 and ascii P2) byte for
    byte the reference loader's, in order; through the native library
    (``native`` true) and through the Python decoder it falls back to."""
    with jfl.FrameLoader(FRAMES_DIR) as fl:
        want = list(fl)
    if not native:
        monkeypatch.setattr(tfl, "_lib", None)
        monkeypatch.setattr(tfl, "_build_failed", True)
    with tfl.FrameLoader(FRAMES_DIR, prefetch_depth=2, device="cpu") as fl:
        assert fl.native is native
        assert (fl.frame_count, fl.width, fl.height) == (5, 32, 24)
        got = list(fl)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(5))
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == torch.uint8 and not g.is_pinned()
        np.testing.assert_array_equal(g.numpy(), w)


def test_torch_frame_loader_empty_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        tfl.FrameLoader(str(tmp_path / "missing_or_empty"), device="cpu")


def _snapshot(path):
    with open(path, "rb") as f:
        return os.stat(path).st_mtime_ns, hashlib.sha256(f.read()).hexdigest()


def test_torch_frame_loader_build_leaves_native_alone(tmp_path, monkeypatch):
    """The port compiles native/frameloader.cpp into its own build
    directory (here a fresh one, so the build really runs) and leaves
    native/libframeloader.so's mtime and bytes as they were. The reference
    loader makes that library first (``make -C native``); a make finished
    in the last seconds is waited out, so that only the port's build falls
    between the two snapshots."""
    assert jfl._get_lib() is not None
    while time.time() - os.stat(NATIVE_SO).st_mtime < 3.0:
        time.sleep(0.5)
    before = _snapshot(NATIVE_SO)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    path, report = cuda_build.build_library(
        tfl.SOURCE, ["g++", *tfl.CXX_FLAGS])
    assert report is not None and path.parent == tmp_path and path.exists()
    assert path.name.startswith("libframeloader_")
    assert _snapshot(NATIVE_SO) == before
    assert cuda_build.build_library(tfl.SOURCE, ["g++", *tfl.CXX_FLAGS]) == (
        path, None)
