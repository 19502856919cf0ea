"""Appearance-based place recognition of the PyTorch port against the JAX
package on the CPU, on test_place_recognition.py's revisit world (24
splats on a textured background, the revisit rigidly shifted with sensor
noise, its 3-D map copy drifted by a similarity).

- ``describe_tracks``: track ids, counts and descriptors equal (bit for
  bit), with repeated observations aggregated to the first.
- ``match_track_groups``: the candidate pairs equal.
- Given the JAX package's RANSAC samples (drawn in the test from its key,
  as its ``ransac`` draws them), ``ransac_similarity_pairs``' inlier mask
  and ``find_loop_pairs``' verified pairs equal.
- With the port's own generator the JAX tests' assertions hold.
"""

import jax
import numpy as np
import pytest
import torch

from surikatoko_tpu.vision import place_recognition as jpr
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.vision import place_recognition as tpr

from test_place_recognition import revisit_world  # noqa: F401 (fixture)

torch.set_num_threads(2)


def jax_samples(key, n, iterations=256, s=3):
    """The minimal samples the JAX ``ransac`` draws from ``key``."""
    return torch.as_tensor(np.array(jax.vmap(
        lambda k: jax.random.choice(k, n, (s,), replace=False))(
            jax.random.split(key, iterations))), dtype=torch.int64)


def _groups(world, noisy=True):
    centers, amps, base, revisit, shift = world
    rng = np.random.default_rng(1)
    n = len(centers)
    jit = (lambda: rng.normal(scale=0.4, size=centers.shape)) if noisy else (
        lambda: 0.0)
    head = [(base, centers + jit(), list(range(n)))]
    tail = [(revisit, centers + shift + jit(), [100 + i for i in range(n)])]
    pts = np.concatenate([centers / 50.0, rng.uniform(2.0, 4.0, (n, 1))], 1)
    s, th = 1.07, 0.1
    Rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    drift = (s * pts @ Rz.T) + np.array([0.3, -0.2, 0.1])
    positions = {i: pts[i] for i in range(n)}
    positions.update({100 + i: drift[i] for i in range(n)})
    return head, tail, positions


def _same_descriptors(ref, out):
    np.testing.assert_array_equal(out.tids, np.asarray(ref.tids))
    np.testing.assert_array_equal(out.count, np.asarray(ref.count))
    np.testing.assert_array_equal(
        out.desc.numpy(), interop.track_descriptors_from_numpy(
            ref, "cpu").desc.numpy())


@pytest.mark.parametrize("noisy", [False, True])
def test_torch_describe_and_match_equal_jax(revisit_world, noisy):
    head, tail, _ = _groups(revisit_world, noisy)
    refs = [jpr.describe_tracks(g) for g in (head, tail)]
    outs = [tpr.describe_tracks(g, device="cpu") for g in (head, tail)]
    for r, o in zip(refs, outs):
        _same_descriptors(r, o)
    assert (tpr.match_track_groups(outs[1], outs[0])
            == jpr.match_track_groups(refs[1], refs[0]))


def test_torch_describe_tracks_aggregates_like_jax(revisit_world):
    """test_describe_tracks_aggregates_across_frames' groups: each track's
    first observation, its count of observations."""
    centers, _, base, revisit, _ = revisit_world
    n, half = len(centers), len(centers) // 2
    frames = [(base, centers[:half], list(range(half))),
              (base, centers[half:], list(range(half, n))),
              (revisit, centers[:3] + 2.0, [0, 1, 2]),
              (base, centers[:0], [])]
    out = tpr.describe_tracks(frames, device="cpu")
    _same_descriptors(jpr.describe_tracks(frames[:3]), out)
    assert out.tids.tolist() == list(range(n))
    assert out.count[:3].tolist() == [2, 2, 2]
    assert tuple(out.desc.shape) == (n, 8) and out.desc.dtype == torch.int32
    empty = tpr.describe_tracks([], device="cpu")
    assert empty.tids.size == 0 and tuple(empty.desc.shape) == (0, 8)
    assert tpr.match_track_groups(empty, out) == []


def test_torch_find_loop_pairs_equals_jax_given_samples(revisit_world):
    head, tail, positions = _groups(revisit_world)
    h_j, t_j = jpr.describe_tracks(head), jpr.describe_tracks(tail)
    key = jax.random.PRNGKey(2)
    ref = jpr.find_loop_pairs(t_j, h_j, positions, ransac_threshold=0.05,
                              key=key)
    h_t, t_t = (tpr.describe_tracks(g, device="cpu") for g in (head, tail))
    cand = tpr.match_track_groups(t_t, h_t)
    n = sum(1 for a, b in cand if a in positions and b in positions)
    out = tpr.find_loop_pairs(t_t, h_t, positions, ransac_threshold=0.05,
                              samples=jax_samples(key, n))
    assert out == ref and len(out) >= len(head[0][2]) // 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_ransac_similarity_equals_jax_given_samples(dtype):
    """test_ransac_similarity_rejects_outliers' data (60 points, 18 gross
    outliers); float32 runs the same samples in the card's type."""
    rng = np.random.default_rng(5)
    n = 60
    A = rng.uniform(-2, 2, (n, 3))
    th = 0.4
    Rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    B = 1.3 * A @ Rz.T + np.array([0.5, -1.0, 2.0])
    B += rng.normal(scale=0.005, size=B.shape)
    bad = rng.choice(n, 18, replace=False)
    B[bad] += rng.uniform(0.5, 2.0, (18, 3)) * rng.choice([-1, 1], (18, 3))
    key = jax.random.PRNGKey(1)
    ref = jpr.ransac_similarity_pairs(A, B, threshold=0.05, key=key)
    out = tpr.ransac_similarity_pairs(A, B, 0.05, samples=jax_samples(key, n),
                                      device="cpu", dtype=dtype)
    np.testing.assert_array_equal(out, ref)
    # the port's own draws: every true inlier kept, every outlier rejected
    own = tpr.ransac_similarity_pairs(
        A, B, 0.05, torch.Generator().manual_seed(1), device="cpu",
        dtype=dtype)
    good = np.ones(n, bool)
    good[bad] = False
    assert own[good].all() and not own[bad].any()
    assert not tpr.ransac_similarity_pairs(A[:2], B[:2], 0.05,
                                           device="cpu").any()


@pytest.mark.parametrize("seed", [0, 2, 7])
def test_torch_find_loop_pairs_own_generator(revisit_world, seed):
    """test_find_loop_pairs_without_oracle and
    test_match_track_groups_needs_no_positions on the port, its RANSAC
    drawing from its own generator."""
    head, tail, positions = _groups(revisit_world)
    h, t = (tpr.describe_tracks(g, device="cpu") for g in (head, tail))
    n = len(head[0][2])
    pairs = tpr.find_loop_pairs(t, h, positions, ransac_threshold=0.05,
                                generator=torch.Generator().manual_seed(seed))
    assert len(pairs) >= n // 2, pairs
    assert all(ta - 100 == hb for ta, hb in pairs), pairs
    h0, t0 = (tpr.describe_tracks(g, device="cpu")
              for g in _groups(revisit_world, noisy=False)[:2])
    cand = tpr.match_track_groups(t0, h0)
    correct = sum(1 for ta, hb in cand if ta - 100 == hb)
    assert correct >= n // 2
    assert correct >= len(cand) - max(2, len(cand) // 4)
    # pairs without a position are dropped before the RANSAC
    assert tpr.find_loop_pairs(t, h, {}, ransac_threshold=0.05) == []
