"""NCC search and corner detection of the PyTorch port against the JAX
package. The search kernel's plain version is held against the Pallas
kernel in interpret mode (the cases of tests/test_ncc_pallas.py and the edge
cases of chip_smoke.ncc_edge_case); the CUDA
kernel itself runs only on the card (tests/test_torch_ncc_cuda.py and
chip_smoke.py)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.ops import ncc as jncc
from surikatoko_tpu.ops.ncc_pallas import ncc_surface_argmax_pallas
from surikatoko_tpu.vision import features as jfeat
from surikatoko_tpu.vision import templ_match as jtm
from surikatoko_tpu.world import device_runner as jdr
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.ops import ncc as tncc
from surikatoko_tpu_torch.ops import ncc_cuda
from surikatoko_tpu_torch.vision import features as tfeat
from surikatoko_tpu_torch.vision import templ_match as ttm
from surikatoko_tpu_torch.world import device_runner as tdr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)
SHAPES = [(8, 9, 7), (5, 17, 25), (3, 9, 11)]   # (K, T, S)


def _case(rng, K, T, S, gate_p=0.7):
    P = S + T - 1
    patches = rng.uniform(0, 255, size=(K, P, P)).astype(np.float32)
    templs = rng.uniform(0, 255, size=(K, T, T)).astype(np.float32)
    gate = rng.uniform(size=(K, S, S)) < gate_p
    gate[:, S // 2, S // 2] = True
    return patches, templs, gate


@pytest.mark.parametrize("K,T,S", SHAPES)
@pytest.mark.parametrize("with_neigh", [False, True])
def test_torch_ncc_plain_matches_pallas(rng, K, T, S, with_neigh):
    """corr within rtol 1e-4 / atol 1e-5 (f32, different summation order),
    idx exact; neighbours where they lie inside the window."""
    p, t, g = _case(rng, K, T, S)
    want = ncc_surface_argmax_pallas(jnp.asarray(p), jnp.asarray(t),
                                     jnp.asarray(g), with_neigh=with_neigh,
                                     interpret=True)
    got = ncc_cuda.ncc_surface_argmax_ref(torch.as_tensor(p), torch.as_tensor(t),
                                          torch.as_tensor(g), with_neigh)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    if with_neigh:
        bi = got[1].numpy()
        bx, by = bi % S, bi // S
        inside = np.stack([bx > 0, bx < S - 1, by > 0, by < S - 1], axis=1)
        np.testing.assert_allclose(got[2].numpy()[inside],
                                   np.asarray(want[2])[inside],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", [c for c in chip_smoke.NCC_EDGE_CASES
                                  if c != "ragged"])
@pytest.mark.parametrize("with_neigh", [False, True])
def test_torch_ncc_plain_matches_pallas_edge_cases(name, with_neigh):
    """The semantics a redesigned kernel must keep, on chip_smoke's edge
    cases: plain version and Pallas kernel agree (idx exact, corr within
    rtol 1e-4 / atol 1e-5, -inf on the same rows), and idx is the one the
    case fixes: the first gated cell of a flat surface, the lowest of
    several cells with equal bits, index 0 for an all-false gate, the
    corner that holds the template. Neighbours equal the Pallas kernel's
    wherever best + d lies in [0, S^2), and the port's surface at the
    clamped index everywhere."""
    p, t, g = chip_smoke.ncc_edge_case(name, np.random.default_rng(5))
    K, S, _ = g.shape
    want = ncc_surface_argmax_pallas(jnp.asarray(p), jnp.asarray(t),
                                     jnp.asarray(g), with_neigh=with_neigh,
                                     interpret=True)
    got = ncc_cuda.ncc_surface_argmax_ref(torch.as_tensor(p), torch.as_tensor(t),
                                          torch.as_tensor(g), with_neigh)
    idx, corr = got[1].numpy(), got[0].numpy()
    np.testing.assert_array_equal(idx, np.asarray(want[1]))
    np.testing.assert_allclose(corr, np.asarray(want[0]), rtol=1e-4, atol=1e-5)
    surf = ttm.corr_coeff_surface(torch.as_tensor(p),
                                  torch.as_tensor(t)).numpy().reshape(K, S * S)
    flat_g = g.reshape(K, S * S)
    gated = np.where(flat_g, surf, -np.inf)
    if name == "flat":
        assert (surf == 0).all()
        np.testing.assert_array_equal(idx, np.argmax(flat_g, axis=1))
    elif name.startswith("ties"):
        best = gated == gated.max(axis=1, keepdims=True)
        assert (best.sum(axis=1) >= 2).all()
        np.testing.assert_array_equal(idx, np.argmax(best, axis=1))
    elif name == "gated_rows":
        assert np.isneginf(corr[::3]).all() and (idx[::3] == 0).all()
        assert np.isfinite(corr[1::3]).all()
    elif name == "corners":
        corner = np.array([0, S - 1, S * (S - 1), S * S - 1])[np.arange(K) % 4]
        np.testing.assert_array_equal(idx, corner)
    if with_neigh:
        nb = idx[:, None] + np.array([-1, 1, -S, S])[None, :]
        np.testing.assert_array_equal(
            got[2].numpy(),
            np.take_along_axis(surf, np.clip(nb, 0, S * S - 1), axis=1))
        inside = (nb >= 0) & (nb < S * S)
        np.testing.assert_allclose(got[2].numpy()[inside],
                                   np.asarray(want[2])[inside],
                                   rtol=1e-4, atol=1e-5)


def test_torch_ncc_all_gated_out(rng):
    """An all-false gate gives corr -inf at index 0, as the TPU kernel does."""
    p, t, _ = _case(rng, 3, 9, 7)
    g = np.zeros((3, 7, 7), bool)
    g[1, 2, 3] = True
    corr, idx = ncc_cuda.ncc_surface_argmax_ref(
        torch.as_tensor(p), torch.as_tensor(t), torch.as_tensor(g))
    wc, wi = ncc_surface_argmax_pallas(jnp.asarray(p), jnp.asarray(t),
                                       jnp.asarray(g), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    assert idx.tolist()[0] == 0 and idx.tolist()[1] == 2 * 7 + 3
    assert np.isneginf(corr.numpy()[[0, 2]]).all()
    np.testing.assert_allclose(corr.numpy(), np.asarray(wc), rtol=1e-4, atol=1e-5)


def test_torch_ncc_wrapper_device_dispatch(rng):
    """CPU tensors take the plain version and launch nothing; any other
    non-CUDA device is refused rather than computed."""
    p, t, g = (torch.as_tensor(a) for a in _case(rng, 4, 9, 7))
    before = ncc_cuda.LAUNCHES
    got = ncc_cuda.ncc_surface_argmax(p, t, g, with_neigh=True)
    want = ncc_cuda.ncc_surface_argmax_ref(p, t, g, with_neigh=True)
    assert ncc_cuda.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ncc_cuda.ncc_surface_argmax(p.to("meta"), t.to("meta"), g.to("meta"))


def test_torch_corr_coeff_surface_f64(rng):
    p, t, _ = _case(rng, 6, 9, 11)
    p, t = p.astype(np.float64), t.astype(np.float64)
    st_j = jtm.template_stats(jnp.asarray(t))
    st_t = ttm.template_stats(torch.as_tensor(t))
    np.testing.assert_allclose(st_t.mean.numpy(), np.asarray(st_j.mean), rtol=1e-12)
    np.testing.assert_allclose(st_t.sqrt_sum_sqr_diff.numpy(),
                               np.asarray(st_j.sqrt_sum_sqr_diff), rtol=1e-12)
    np.testing.assert_allclose(
        ttm.corr_coeff_surface(torch.as_tensor(p), torch.as_tensor(t)).numpy(),
        np.asarray(jtm.corr_coeff_surface(jnp.asarray(p), jnp.asarray(t))),
        rtol=1e-10, atol=1e-12)


def _frame(bg_cell):
    """A rendered 320x240 frame of the wide world (float64), the GT pixels
    of its points, and both packages' scenario/params."""
    sc = jdr.build_imageseq_scenario(capacity=48, n_points=48, dtype=jnp.float64,
                                     image_size=(320, 240), bg_cell=bg_cell,
                                     max_deviation=0.8, world="wide")
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01),
                               dtype=jnp.float64)
    params = j_make_params(cam, None, dtype=jnp.float64)
    img = jdr.render_frame(params, sc, jnp.asarray(5))
    xc = sc.gt_points @ sc.gt_cfw_R[5].T + sc.gt_cfw_t[5]
    pix = jcam.project_camera_point(cam, None, xc)
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return (np.array(img), np.array(pix), sc, params,
            interop.scenario_from_numpy(np_(sc), device="cpu"),
            interop.params_from_numpy(np_(params), device="cpu"))


@pytest.fixture(scope="module")
def frame():
    """Smooth low-frequency background: the benchmark's kind of frame."""
    return _frame(32)


@pytest.fixture(scope="module")
def noise_frame():
    """Per-pixel noise background: well-conditioned ZNCC surfaces, so the
    f32 and f64 searches agree beyond their rounding."""
    return _frame(None)


def test_torch_render_frame_matches_jax(frame):
    img, _, _, _, tsc, tp = frame
    np.testing.assert_allclose(tdr.render_frame(tp, tsc, 5).numpy(), img,
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("subpixel", [False, True])
def test_torch_ncc_search_matches_jax(rng, noise_frame, subpixel):
    """Against the JAX XLA path (use_pallas=False) in float64. The port
    searches on the kernel's f32 surface, as the JAX Pallas path does, so
    corr agrees to f32 rounding and subpixel centers to 1e-4 px. On a
    smooth background the window variance cancels (ws2 - ws^2/n) and f32
    surfaces differ from f64 by up to ~2e-4, enough to move a subpixel
    parabola; the noise background keeps this comparison about the
    algorithm."""
    img, pix, *_ = noise_frame
    K = pix.shape[0]
    inside = ((pix[:, 0] > 12) & (pix[:, 0] < 308) & (pix[:, 1] > 12)
              & (pix[:, 1] < 228))
    templates = np.array(jdr._gather_templates(jnp.asarray(img),
                                                 jnp.asarray(pix), 15))
    centers = pix + rng.normal(scale=2.0, size=pix.shape)
    L = rng.normal(scale=1.5, size=(K, 2, 2))
    cov = L @ L.transpose(0, 2, 1) + 2.0 * np.eye(2)
    sigma_inv = np.linalg.inv(cov)
    active = inside & (rng.uniform(size=K) < 0.9)
    kw = dict(search_radius=7, min_corr_coeff=0.6, chi2_gate=5.99146,
              subpixel=subpixel)
    rj = jncc.ncc_search(jnp.asarray(img), jnp.asarray(centers),
                         jnp.asarray(templates), jnp.asarray(active),
                         sigma_inv=jnp.asarray(sigma_inv), use_pallas=False, **kw)
    rt = tncc.ncc_search(torch.as_tensor(img), torch.as_tensor(centers),
                         torch.as_tensor(templates), torch.as_tensor(active),
                         sigma_inv=torch.as_tensor(sigma_inv), **kw)
    for f in ("matched", "n_gated", "in_ellipse"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    assert int(rt.matched.sum()) >= 10
    np.testing.assert_allclose(rt.best_center.numpy(), np.asarray(rj.best_center),
                               atol=1e-4 if subpixel else 0.0)
    np.testing.assert_allclose(rt.best_corr.numpy(), np.asarray(rj.best_corr),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stats", ["own", "scaled"])
def test_torch_make_ncc_search_with_templ_stats_matches_jax(rng, noise_frame,
                                                            stats):
    """make_ncc_search's closure with ``templ_stats`` against JAX's
    (use_pallas=False, float32 frame as the matcher passes it): the
    templates' own stats, and stats whose norms are scaled by 1.5 (every
    corr shrinks by 1/1.5, so the port's CPU surface must take the given
    stats, not its own). Centres, matches and gate telemetry equal; corr
    within rtol 1e-4 / atol 1e-5."""
    img, pix, *_ = noise_frame
    img = img.astype(np.float32)
    K = pix.shape[0]
    templates = np.array(jdr._gather_templates(jnp.asarray(img),
                                                 jnp.asarray(pix), 15))
    centers = (pix + rng.normal(scale=2.0, size=pix.shape)).astype(np.float32)
    inside = ((pix[:, 0] > 12) & (pix[:, 0] < 308) & (pix[:, 1] > 12)
              & (pix[:, 1] < 228))
    st_j = jtm.template_stats(jnp.asarray(templates))
    if stats == "scaled":
        st_j = st_j._replace(sqrt_sum_sqr_diff=1.5 * st_j.sqrt_sum_sqr_diff)
    st_t = ttm.TemplateStats(*(torch.as_tensor(np.array(a)) for a in st_j))
    kw = dict(search_radius=7, min_corr_coeff=0.4, chi2_gate=5.99146)
    rj = jncc.make_ncc_search(**kw)(
        jnp.asarray(img), jnp.asarray(centers), jnp.asarray(templates),
        jnp.asarray(inside), templ_stats=st_j)
    rt = tncc.make_ncc_search(**kw)(
        torch.as_tensor(img), torch.as_tensor(centers),
        torch.as_tensor(templates), torch.as_tensor(inside), templ_stats=st_t)
    for f in ("matched", "n_gated", "in_ellipse", "best_center"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    assert int(rt.matched.sum()) >= 10
    np.testing.assert_allclose(rt.best_corr.numpy(), np.asarray(rj.best_corr),
                               rtol=1e-4, atol=1e-5)
    if stats == "scaled":
        assert float(rt.best_corr[torch.as_tensor(inside)].max()) < 0.7


def test_torch_detect_corners_and_filter(frame):
    """Valid corners (positions and order) equal on a rendered frame; the
    suppression near tracked points agrees."""
    img, pix, *_ = frame
    kw = dict(max_corners=32, nms_radius=5, border=15, quality_level=0.05)
    xy_j, ok_j = jfeat.detect_corners(jnp.asarray(img), **kw)
    xy_t, ok_t = tfeat.detect_corners(torch.as_tensor(img), **kw)
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    assert ok.sum() >= 5
    np.testing.assert_array_equal(xy_t.numpy()[ok], np.asarray(xy_j)[ok])
    np.testing.assert_allclose(tfeat.shi_tomasi_response(torch.as_tensor(img)).numpy(),
                               np.asarray(jfeat.shi_tomasi_response(jnp.asarray(img))),
                               rtol=1e-5, atol=1e-3)
    exist_ok = np.arange(len(pix)) % 2 == 0
    f_j = jfeat.filter_out_closest(xy_j, ok_j, jnp.asarray(pix),
                                   jnp.asarray(exist_ok), 14.0)
    f_t = tfeat.filter_out_closest(xy_t, ok_t, torch.as_tensor(pix),
                                   torch.as_tensor(exist_ok), 14.0)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
