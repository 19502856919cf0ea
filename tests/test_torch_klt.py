"""The ported pyramidal Lucas-Kanade tracker (vision/klt.py) against the JAX
package's, on the CPU, on tests/test_klt.py's cases: the same images and
points go to both. Pyramid levels within rtol 1e-6 (float32, the blur sums
its five taps in another order than XLA's convolution), tracked points
within 1e-4 px and status equal. Each case also carries the reference
test's own assertions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.vision import klt as jklt
from surikatoko_tpu_torch.vision import klt as tklt

from test_descriptors import textured_image
from test_klt import multiscale_texture, warp_translate

torch.set_num_threads(2)
PYR_RTOL = 1e-6
PTS_TOL = 1e-4


def _both(img0, img1, pts, **kw):
    want = jklt.track_points(jnp.asarray(img0), jnp.asarray(img1),
                             jnp.asarray(pts, jnp.float32), **kw)
    got = tklt.track_points(torch.as_tensor(img0), torch.as_tensor(img1),
                            torch.as_tensor(np.asarray(pts, np.float32)), **kw)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=PTS_TOL, rtol=0)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    return got


@pytest.mark.parametrize("size", [(240, 320), (121, 97)])
def test_torch_pyramid_matches_jax(rng, size):
    """Shapes and values at an even and an odd size (XLA's "SAME" pads the
    stride-2 blur asymmetrically at an even size)."""
    img, _ = textured_image(rng, size)
    want = jklt.build_pyramid(jnp.asarray(img), 3)
    got = tklt.build_pyramid(torch.as_tensor(img), 3)
    assert [tuple(p.shape) for p in got] == [p.shape for p in want]
    if size == (240, 320):
        assert [tuple(p.shape) for p in got] == [(240, 320), (120, 160), (60, 80)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PYR_RTOL,
                                   atol=0)


def test_torch_klt_subpixel_small_shift(rng):
    img, pts = textured_image(rng)
    shift = np.array([2.3, -1.7])
    img1 = warp_translate(img, shift).astype(np.float32)
    res = _both(img, img1, pts, levels=1)
    good = res.status.numpy()
    assert good.sum() >= 10
    flow = res.points.numpy()[good] - pts[good]
    np.testing.assert_allclose(np.median(flow, axis=0), shift, atol=0.1)
    assert np.abs(flow - shift).max() < 0.5


@pytest.mark.parametrize("levels", [1, 3])
def test_torch_klt_pyramid_pull_in(rng, levels):
    img, pts = multiscale_texture(rng)
    shift = np.array([14.0, 9.0])
    img1 = warp_translate(img, shift).astype(np.float32)
    res = _both(img, img1, pts, levels=levels)
    if levels == 3:
        good = res.status.numpy()
        assert good.sum() >= 8
        flow = res.points.numpy() - pts
        np.testing.assert_allclose(np.median(flow[good], axis=0), shift, atol=0.3)


def test_torch_klt_flat_region_flagged(rng):
    img, _ = textured_image(rng)
    img = img.copy()
    img[80:160, 100:220] = 100.0
    pts = np.array([[160.0, 120.0], [60.0, 60.0]], np.float32)
    img1 = warp_translate(img, np.array([1.0, 1.0])).astype(np.float32)
    res = _both(img, img1, pts, levels=1)
    assert not bool(res.status[0]) and bool(res.status[1])


def test_torch_klt_valid_mask_and_bilinear_border(rng):
    """The ``valid`` mask, and points near and past the border, where the
    bilinear sample clamps to W - 1.001."""
    img, _ = textured_image(rng, (96, 128))
    img1 = warp_translate(img, np.array([0.6, -0.4])).astype(np.float32)
    pts = np.array([[1.0, 1.0], [126.5, 94.5], [60.0, 50.0], [-3.0, 110.0],
                    [20.0, 20.0]], np.float32)
    valid = np.array([True, True, True, True, False])
    want = jklt.track_points(jnp.asarray(img), jnp.asarray(img1),
                             jnp.asarray(pts), jnp.asarray(valid), levels=2,
                             win=5, iters=6)
    got = tklt.track_points(torch.as_tensor(img), torch.as_tensor(img1),
                            torch.as_tensor(pts), torch.as_tensor(valid),
                            levels=2, win=5, iters=6)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=PTS_TOL, rtol=0)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error),
                               rtol=1e-5, atol=1e-4)
    assert not bool(got.status[4])
    xs = torch.as_tensor([0.0, 127.5, 200.0, -5.0])
    ys = torch.as_tensor([95.9, 0.0, 10.0, 70.0])
    np.testing.assert_allclose(
        tklt._bilinear(torch.as_tensor(img), xs, ys).numpy(),
        np.asarray(jklt._bilinear(jnp.asarray(img), jnp.asarray(xs.numpy()),
                                  jnp.asarray(ys.numpy()))), rtol=1e-6)
