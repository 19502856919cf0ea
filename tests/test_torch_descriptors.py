"""Binary descriptors, Hamming matching and the scale-space keypoints of the
PyTorch port against the JAX package on the CPU.

- BRIEF, steered BRIEF: the descriptors equal bit for bit (the port's int32
  words hold the JAX uint32 words' bit patterns) on test_descriptors.py's
  textured image, its shifted and quarter-turned copies, and on a frame
  rendered by the at-scale MVF demo's world; the orientations within 1e-4
  rad (both packages sum the moments in float32, in their own order).
- Hamming distances and matches equal on the same words.
- Multiscale: ``resize_bilinear`` within 5e-3 (0-255 scale) at the
  pyramid's levels and at a 2x zoom; ``detect_and_describe``'s valid
  keypoints, scales and descriptors equal and its angles within 1e-4 on
  test_multiscale.py's images; ``similarity_consistent_matches`` equal.
- The JAX tests' behaviour checks, run on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.vision import descriptors as jdesc
from surikatoko_tpu.vision import features as jfeat
from surikatoko_tpu.vision import multiscale as jms
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.demos import mvf_at_scale
from surikatoko_tpu_torch.vision import descriptors as tdesc
from surikatoko_tpu_torch.vision import features as tfeat
from surikatoko_tpu_torch.vision import multiscale as tms

from test_descriptors import rot90_points, textured_image
from test_klt import multiscale_texture

torch.set_num_threads(2)

THETA_TOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _words(d) -> np.ndarray:
    """JAX uint32 words as the port's int32 words."""
    return interop.descriptor_words(np.asarray(d), "cpu").numpy()


def _demo_frame():
    """Frame 3 of the at-scale MVF demo's world at bench.py's smoke size,
    rendered as the demo renders it, with its noisy keypoints."""
    args = mvf_at_scale.make_args(points=300, frames=40, revisit_frames=8,
                                  device="cpu")
    w = mvf_at_scale.World(args)
    ts = mvf_at_scale.TrackStore(2 * w.n_pts, w.n_total, 2 * args.track_len)
    for f in range(4):
        w.write_corners(ts, f)
    img, kps, _ = w.head_obs[3]
    return img, kps


def _case(name):
    rng = np.random.default_rng(20260817)
    img, pts = textured_image(rng)
    if name == "textured":
        return img, pts
    if name == "shifted":
        return np.roll(img, (0, 5), axis=(0, 1)), pts + [5.0, 0.0]
    if name == "rot90":
        return np.ascontiguousarray(np.rot90(img)), rot90_points(pts, img.shape[1])
    return _demo_frame()


CASES = ("textured", "shifted", "rot90", "demo_render")


@pytest.mark.parametrize("name", CASES)
def test_torch_brief_equals_jax(name):
    img, pts = _case(name)
    v = np.ones(len(pts), bool)
    v[::5] = False
    ref = jdesc.compute_brief(jnp.asarray(img), jnp.asarray(pts, jnp.float32),
                              jnp.asarray(v))
    out = tdesc.compute_brief(_t(img), _t(pts.astype(np.float32)), _t(v))
    assert out.dtype == torch.int32 and out.shape == (len(pts), tdesc.N_WORDS)
    np.testing.assert_array_equal(out.numpy(), _words(ref))


@pytest.mark.parametrize("name", CASES)
def test_torch_oriented_brief_equals_jax(name):
    """Keypoints in float64 here (the demo hands its host float64 pixels to
    both packages)."""
    img, pts = _case(name)
    v = np.ones(len(pts), bool)
    ref, th_ref = jdesc.compute_oriented_brief(jnp.asarray(img),
                                               jnp.asarray(pts), jnp.asarray(v))
    out, th = tdesc.compute_oriented_brief(_t(img), _t(pts), _t(v))
    np.testing.assert_array_equal(out.numpy(), _words(ref))
    np.testing.assert_allclose(th.numpy(), np.asarray(th_ref), rtol=0,
                               atol=THETA_TOL)


def test_torch_orientations_equal_jax():
    """The ramps of test_orientation_follows_gradient and the textured
    image's keypoints, some within the radius of the border (clipped)."""
    H, W = 96, 96
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    kp = np.array([[48.0, 48.0], [3.0, 90.0], [47.5, 48.5]], np.float32)
    for img in (xx, yy, _case("textured")[0][:96, :96]):
        ref = jdesc.keypoint_orientations(jnp.asarray(img), jnp.asarray(kp))
        out = tdesc.keypoint_orientations(_t(img), _t(kp))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=THETA_TOL)
    th = tdesc.keypoint_orientations(_t(xx), _t(kp[:1]))
    assert abs(float(th[0])) < 0.05
    th = tdesc.keypoint_orientations(_t(yy), _t(kp[:1]))
    assert abs(float(th[0]) - np.pi / 2) < 0.05


def test_torch_hamming_and_match_equal_jax():
    """Random words (half with the top bit set), near duplicates (distance
    ties and ratio-test edges) and invalid slots."""
    rng = np.random.default_rng(4)
    da = rng.integers(0, 2**32, size=(40, 8), dtype=np.uint64).astype(np.uint32)
    db = da[rng.permutation(40)[:30]].copy()
    flip = rng.integers(0, 2**32, size=db.shape, dtype=np.uint64).astype(np.uint32)
    db ^= flip & rng.integers(0, 2**32, size=db.shape,
                              dtype=np.uint64).astype(np.uint32) & 0x01010101
    db[5] = db[4]                                   # exact tie in B
    va = rng.uniform(size=40) > 0.1
    vb = rng.uniform(size=30) > 0.1
    Dj = np.asarray(jdesc.hamming_matrix(jnp.asarray(da), jnp.asarray(db)))
    Dt = tdesc.hamming_matrix(_t(_words(da)), _t(_words(db))).numpy()
    np.testing.assert_array_equal(Dt, Dj)
    np.testing.assert_array_equal(
        tdesc.popcount32(_t(_words(da))).numpy(),
        np.vectorize(lambda x: bin(int(x)).count("1"))(da))
    for max_d, ratio in ((64, 0.85), (120, 0.95), (256, 1.0)):
        ref = jdesc.match_descriptors(jnp.asarray(da), jnp.asarray(db),
                                      jnp.asarray(va), jnp.asarray(vb),
                                      max_distance=max_d, ratio=ratio)
        out = tdesc.match_descriptors(_t(_words(da)), _t(_words(db)), _t(va),
                                      _t(vb), max_distance=max_d, ratio=ratio)
        for f in ("idx_b", "distance", "good"):
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.asarray(getattr(ref, f)), f)


def test_torch_oriented_matching_rotated_view():
    """test_oriented_matching_rotated_view on the port: steered descriptors
    of a quarter-turned image match back to the identity permutation."""
    img, _ = _case("textured")
    W = img.shape[1]
    img2 = np.ascontiguousarray(np.rot90(img))
    kp1, v1 = tfeat.detect_corners(_t(img), max_corners=24, nms_radius=8,
                                   border=36)
    d1, _ = tdesc.compute_oriented_brief(_t(img), kp1, v1)
    kp2 = _t(rot90_points(kp1.numpy(), W).astype(np.float32))
    d2, _ = tdesc.compute_oriented_brief(_t(img2), kp2, v1)
    m = tdesc.match_descriptors(d1, d2, v1, v1, max_distance=80, ratio=0.9)
    good = m.good.numpy()
    assert good.sum() >= 8, good.sum()
    assert (m.idx_b.numpy()[good] == np.nonzero(good)[0]).mean() >= 0.9


def _zoom_pair():
    img, _ = multiscale_texture(np.random.default_rng(20260817))
    H, W = img.shape
    crop = img[H // 4: 3 * H // 4, W // 4: 3 * W // 4]
    return img, crop


def test_torch_resize_bilinear_within_jax():
    img, _ = _case("textured")
    big, crop = _zoom_pair()
    for src, hw in [(img, s) for s in tms.pyramid_shapes(img.shape, 4)[1:]] + [
            (crop, big.shape), (big, (97, 131))]:
        ref = np.asarray(jms.resize_bilinear(jnp.asarray(src), hw))
        out = tms.resize_bilinear(_t(src), hw).numpy()
        assert out.shape == ref.shape == tuple(hw)
        np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3)


def _compare_scale_space(ref, out):
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), v)
    np.testing.assert_array_equal(out.xy.numpy()[v], np.asarray(ref.xy)[v])
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(out.descriptors.numpy(),
                                  _words(ref.descriptors))
    np.testing.assert_allclose(out.angle.numpy()[v], np.asarray(ref.angle)[v],
                               rtol=0, atol=THETA_TOL)


@pytest.mark.parametrize("which", ["textured_3_levels", "zoom_4_levels"])
def test_torch_detect_and_describe_equals_jax(which):
    """test_pyramid_roundtrip_coords' image at 3 levels; both views of
    test_matching_across_2x_zoom at 4 levels of 48 corners (NMS 5). The
    zoomed view is the JAX resize's, so both packages see one image."""
    if which == "textured_3_levels":
        imgs, kw = [_case("textured")[0]], dict(levels=3)
    else:
        img, crop = _zoom_pair()
        zoom = np.asarray(jms.resize_bilinear(jnp.asarray(crop), img.shape))
        imgs, kw = [img, zoom], dict(levels=4, corners_per_level=48,
                                     nms_radius=5)
    refs, outs = [], []
    for im in imgs:
        refs.append(jms.detect_and_describe(jnp.asarray(im), **kw))
        outs.append(tms.detect_and_describe(im, device="cpu", **kw))
        _compare_scale_space(refs[-1], outs[-1])
    if len(imgs) == 2:
        a, b = outs
        m = tdesc.match_descriptors(a.descriptors, b.descriptors, a.valid,
                                    b.valid, max_distance=80, ratio=0.95)
        good = tms.similarity_consistent_matches(a, b, m.idx_b, m.good)
        mj = jdesc.match_descriptors(refs[0].descriptors, refs[1].descriptors,
                                     refs[0].valid, refs[1].valid,
                                     max_distance=80, ratio=0.95)
        good_j = jms.similarity_consistent_matches(refs[0], refs[1],
                                                   mj.idx_b, mj.good)
        np.testing.assert_array_equal(good, good_j)
        # test_matching_across_2x_zoom's checks on the port's matches
        H, W = imgs[0].shape
        assert good.sum() >= 4, good.sum()
        xa = a.xy.numpy()[good]
        xb = b.xy.numpy()[m.idx_b.numpy()[good]]
        err = np.linalg.norm(xb - 2.0 * (xa - [W / 4, H / 4]), axis=1)
        assert np.median(err) < 4.0
        ratio = b.scale.numpy()[m.idx_b.numpy()[good]] / a.scale.numpy()[good]
        assert abs(np.median(np.log2(ratio)) - 1.0) < 0.35
    else:
        out = outs[0]
        xy = out.xy.numpy()[out.valid.numpy()]
        H, W = imgs[0].shape
        assert ((xy >= 0) & (xy < [W, H])).all()
        assert len(np.unique(np.round(out.scale.numpy()[out.valid.numpy()],
                                      3))) >= 2
