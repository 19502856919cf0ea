"""The at-scale MVF pipeline of the PyTorch port against the JAX package, in
float64 on the CPU (the demo's SE(3) closure is in test_torch_mvf.py, the
Sim(3) closure and the moderate-scale run in test_torch_mvf_closure.py).

- ``demos.mvf_at_scale.run_at_scale`` at bench.py's smoke size (300 points,
  40 frames + an 8-frame revisit, oracle pairs; bench.py:629-636) against
  the JAX demo's ``run_at_scale``: the world's points and noise bit for bit
  (one generator, drawn in the JAX demo's order), its camera path within
  1e-14 (the look-at rounds in XLA's and torch's own ways, by up to one
  ulp), the corners the track stores receive within 1e-9 px; the metrics
  within the tolerances below.

The robust closure fit draws its random minimal triples from numpy here
and from a JAX key there (geom/align.py), so the two closures rest on
other inlier sets (38 against 39 of 300 pairs at the smoke size). To hold
the rest of the pipeline to the JAX package, the at-scale comparison hands
the port the JAX package's robust fit (the same inputs give the same
inliers); the port's own fit is run too, and held to the JAX run's
trajectory ATE within 5%.

- The oracle-free closure (the JAX demo's default: place recognition over
  the rendered head and revisit frames) at the same size, with the JAX
  robust fit and the JAX place-recognition RANSAC's samples handed in
  (its key, PRNGKey(0), drawn as its ``ransac`` draws): the tracks, the
  appearance candidates (24), the verified and correct pairs and the
  closure inliers equal the JAX demo's, the ATEs within 5e-6.
"""

import contextlib
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom.align import umeyama_similarity_robust as j_robust
from surikatoko_tpu_torch.demos import mvf_at_scale as tscale
from surikatoko_tpu_torch.geom import align as talign
from surikatoko_tpu_torch.models.sfm import ransac as transac

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))
torch.set_num_threads(2)

SMOKE = dict(points=300, frames=40, revisit_frames=8, window_ba_every=8,
             global_ba_every=20, ba_iters=3, final_polish_iters=10,
             oracle_pairs=True)


def _jax_world(args):
    """The JAX demo's world (demo_mvf_at_scale.py:109-150, its draws in its
    order): points, camera path, and each frame's corners as the track
    store receives them."""
    from surikatoko_tpu.geom import se3 as jse3
    from surikatoko_tpu.models.mvf import TrackStore
    rng = np.random.default_rng(args.seed)
    n_pts, n_base, L = args.points, args.frames, args.track_len
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    rad = 2.0 + rng.normal(scale=0.3, size=n_pts)
    z = rng.uniform(0, 3.0, n_pts)
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], axis=1)
    n_total = n_base + args.revisit_frames
    Rs, ts_gt = [], []
    for k in range(n_total):
        a = 2 * np.pi * (k % n_base) / n_base
        eye = np.array([8.0 * np.cos(a), 8.0 * np.sin(a), 1.5])
        cfw = jse3.look_at_luf_wfc(jnp.asarray(eye), jnp.asarray([0.0, 0, 1.5]),
                                   jnp.asarray([0.0, 0, 1])).inv()
        Rs.append(np.asarray(cfw.R))
        ts_gt.append(np.asarray(cfw.t))
    rng.uniform(80.0, 200.0, n_pts)
    rng.uniform(1.6, 2.6, n_pts)
    rng.uniform(20.0, 60.0, size=(480, 640))
    facing = (ang / (2 * np.pi) * n_base).astype(int)
    frame_pts = [[] for _ in range(n_total)]
    for i in range(n_pts):
        for k in range(L):
            if facing[i] + k < n_base:
                frame_pts[facing[i] + k].append(i)
    for f in range(n_base, n_total):
        for i in np.nonzero((f % n_base - facing) % n_base < L)[0]:
            frame_pts[f].append(int(i))
    ts = TrackStore(2 * n_pts, n_total, 2 * L)
    K_inv = np.linalg.inv(tscale.K)
    for f in range(n_total):
        ids = np.asarray(frame_pts[f], int)
        xc = pts[ids] @ Rs[f].T + ts_gt[f]
        ok = xc[:, 2] > 0.5
        ph = xc @ tscale.K.T
        pix = ph[:, :2] / ph[:, 2:3] + rng.normal(scale=args.noise_pix,
                                                  size=(len(ids), 2))
        head = facing[ids] < n_base // 2
        for tid, p, o, hd in zip(ids, pix, ok, head):
            if o:
                ts.add_corner(int(tid) + n_pts if (f >= n_base and hd)
                              else int(tid), f, p, K_inv)
    return pts, np.stack(Rs), np.stack(ts_gt), ts, rng


def test_torch_mvf_at_scale_world_equals_jax_demo():
    args = tscale.make_args(**SMOKE, device="cpu")
    pts, Rs, ts_gt, jts, rng_j = _jax_world(args)
    world = tscale.World(args)
    np.testing.assert_array_equal(world.pts_gt, pts)
    np.testing.assert_allclose(world.Rs, Rs, rtol=0, atol=1e-14)
    np.testing.assert_allclose(world.ts_gt, ts_gt, rtol=0, atol=1e-14)
    tts = tscale.TrackStore(2 * args.points, world.n_total, 2 * args.track_len)
    for f in range(world.n_total):
        world.write_corners(tts, f)
    for name in ("fidx", "count", "n_tracks"):
        np.testing.assert_array_equal(getattr(tts, name), getattr(jts, name))
    np.testing.assert_allclose(tts.pixels, jts.pixels, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tts.coords, jts.coords, rtol=0, atol=1e-12)
    # both generators drew the same stream to its last draw
    assert world.rng.bit_generator.state == rng_j.bit_generator.state
    assert tts._frame_tracks == jts._frame_tracks


def _robust_from_jax(src, dst, **kw):
    """The JAX package's robust similarity on the port's tensors."""
    out = j_robust(jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()), **kw)
    return tuple(torch.as_tensor(np.asarray(x)) for x in out)


@pytest.fixture(scope="module")
def jax_at_scale():
    from demo_mvf_at_scale import make_args, run_at_scale
    with contextlib.redirect_stdout(io.StringIO()):
        return run_at_scale(make_args(**SMOKE))


def test_torch_mvf_at_scale_matches_jax_demo(jax_at_scale, monkeypatch):
    """With the JAX robust fit: the closure's inliers, the counts and the
    final BA's trials equal; the trajectory ATE before the closure, after
    the final BA and the map ATE within 5e-6, half the last digit the JAX
    demo rounds its metrics to (demo_mvf_at_scale.py:407-428)."""
    ref = jax_at_scale
    monkeypatch.setattr(talign, "umeyama_similarity_robust", _robust_from_jax)
    res = tscale.run_at_scale(tscale.make_args(**SMOKE, device="cpu"))
    np.testing.assert_allclose(res["traj_ate_pre_closure"],
                               ref["traj_ate_pre_closure"], rtol=0, atol=5e-6)
    for k in ("loop_closed", "closure_pairs_total", "closure_inliers",
              "localization_failures", "points", "frames",
              "ba_trials_timed"):
        assert res[k] == ref[k], k
    np.testing.assert_allclose(res["map_ate_rmse"], ref["map_ate_rmse"],
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(res["traj_ate_rmse"], ref["traj_ate_rmse"],
                               rtol=0, atol=5e-6)
    assert res["final_ba"]["err_after"] < res["final_ba"]["err_before"]
    assert [r[0] for r in res["ba_log"]] == (
        ["sparse", "window", "window", "sparse", "window"])


def test_torch_mvf_at_scale_own_robust_fit(jax_at_scale):
    """The port's own robust fit (numpy's triples): the loop closes and the
    trajectory ATE lands within 5% of the JAX run's."""
    res = tscale.run_at_scale(tscale.make_args(**SMOKE, device="cpu"))
    assert res["loop_closed"] and res["localization_failures"] == 0
    np.testing.assert_allclose(res["traj_ate_rmse"],
                               jax_at_scale["traj_ate_rmse"], rtol=0.05)
    assert res["map_ate_rmse"] < 0.05
    assert res["closure_pairs_correct"] == -1 and not res["closure_oracle_free"]
    assert res["place_recognition"] is None
    # without the oracle is the default, as in the JAX demo
    assert tscale.make_args().oracle_pairs is False


@pytest.fixture(scope="module")
def jax_oracle_free():
    """The JAX demo's oracle-free run and the place-recognition counts it
    prints."""
    from demo_mvf_at_scale import make_args, run_at_scale
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run_at_scale(make_args(**{**SMOKE, "oracle_pairs": False}))
    m = re.search(r"place recognition: (\d+) revisit x (\d+) head tracks -> "
                  r"(\d+) appearance candidates", out.getvalue())
    return res, tuple(int(x) for x in m.groups())


def _jax_pr_samples(generator, data_size, sample_size, iterations):
    """The JAX demo's place-recognition RANSAC samples (its default key)."""
    return torch.as_tensor(np.array(jax.vmap(
        lambda k: jax.random.choice(k, data_size, (sample_size,),
                                    replace=False))(
            jax.random.split(jax.random.PRNGKey(0), iterations))))


def test_torch_mvf_at_scale_oracle_free_matches_jax_demo(jax_oracle_free,
                                                         monkeypatch):
    ref, (n_rev, n_head, n_cand) = jax_oracle_free
    monkeypatch.setattr(talign, "umeyama_similarity_robust", _robust_from_jax)
    monkeypatch.setattr(transac, "draw_samples", _jax_pr_samples)
    res = tscale.run_at_scale(tscale.make_args(
        **{**SMOKE, "oracle_pairs": False}, device="cpu"))
    prs = res["place_recognition"]
    assert (prs["tracks_revisit"], prs["tracks_head"]) == (n_rev, n_head)
    assert prs["candidates"] == n_cand == 24
    for k in ("loop_closed", "closure_pairs_total", "closure_pairs_correct",
              "closure_inliers", "closure_oracle_free",
              "localization_failures", "points", "frames"):
        assert res[k] == ref[k], k
    assert res["closure_oracle_free"] and res["closure_pairs_correct"] >= 3
    for k in ("traj_ate_pre_closure", "traj_ate_rmse", "map_ate_rmse"):
        np.testing.assert_allclose(res[k], ref[k], rtol=0, atol=5e-6)
    assert set(prs["stage_ms"]) == {"render_ms", "describe_ms", "match_ms",
                                    "ransac_ms"}
