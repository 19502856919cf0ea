"""Rectangles, the utilities and checkpoints of the PyTorch port against
the JAX package on the CPU, float64.

- ``geom/rect``: test_rect_ellipse.py's intersection table and the rest of
  the helpers, equal.
- ``utils``: ``approx`` equal; ``stats``' streaming mean and std within
  1e-12 of the JAX accumulator; ``la.gauss_jordan`` within 1e-12 (the
  same pivots and operations; XLA may fuse the row updates into FMAs)
  with the same ``ok`` flag; ``rand`` given the
  JAX package's normal draws: the samples and the Monte-Carlo covariance
  within 1e-12, the Jacobian propagation within 1e-15; ``profiling``'s
  timer, trace and annotation.
- ``io/checkpoint``: a ``MonoSlamState`` the JAX package saved loads into
  the port's equal, the port's own files round-trip, and a wrong structure
  is refused.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import rect as jrect
from surikatoko_tpu.io import checkpoint as jckpt
from surikatoko_tpu.models.monoslam import init_state as j_init_state
from surikatoko_tpu.utils import approx as japprox
from surikatoko_tpu.utils import la as jla
from surikatoko_tpu.utils import rand as jrand
from surikatoko_tpu.utils import stats as jstats
from surikatoko_tpu_torch.geom import rect as trect
from surikatoko_tpu_torch.io import checkpoint as tckpt
from surikatoko_tpu_torch.models.monoslam import init_state as t_init_state
from surikatoko_tpu_torch.utils import approx as tapprox
from surikatoko_tpu_torch.utils import la as tla
from surikatoko_tpu_torch.utils import profiling as tprof
from surikatoko_tpu_torch.utils import rand as trand
from surikatoko_tpu_torch.utils import stats as tstats

from test_rect_ellipse import CASES

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("a,b,expected", CASES)
def test_torch_rect_intersect_equals_jax(a, b, expected):
    ra, rb = trect.make(*a, device="cpu"), trect.make(*b, device="cpu")
    inter = trect.intersect(ra, rb)
    ref = jrect.intersect(jrect.make(*a), jrect.make(*b))
    np.testing.assert_array_equal(inter.numpy(), np.asarray(ref))
    assert bool(trect.is_empty(inter)) == bool(jrect.is_empty(ref))
    if expected is None:
        assert bool(trect.is_empty(inter))
    else:
        np.testing.assert_allclose(inter.numpy(), expected, atol=1e-12)


def test_torch_rect_helpers_equal_jax():
    r = np.array([[0.0, 0, 10, 10], [-2, 1, 3, 5]])
    p = np.array([[2.0, 3], [9.9, 10.0]])
    for fn, args in (("deflate", (2, 3)), ("center", ()),
                     ("right_bottom", ())):
        np.testing.assert_array_equal(
            getattr(trect, fn)(_t(r), *args).numpy(),
            np.asarray(getattr(jrect, fn)(jnp.asarray(r), *args)))
    np.testing.assert_array_equal(
        trect.centered(_t(p[0]), 4, 2).numpy(),
        np.asarray(jrect.centered(jnp.asarray(p[0]), 4, 2)))
    np.testing.assert_array_equal(
        trect.contains(_t(r), _t(p)).numpy(),
        np.asarray(jrect.contains(jnp.asarray(r), jnp.asarray(p))))
    np.testing.assert_array_equal(
        trect.from_points(_t(p[0]), _t(p[1])).numpy(),
        np.asarray(jrect.from_points(jnp.asarray(p[0]), jnp.asarray(p[1]))))
    np.testing.assert_array_equal(
        trect.clamp_rect_to(_t(r[0]), _t(r[1])).numpy(),
        np.asarray(jrect.clamp_rect_to(jnp.asarray(r[0]), jnp.asarray(r[1]))))
    np.testing.assert_allclose(trect.deflate(trect.make(0, 0, 10, 10,
                                                        device="cpu"), 2, 3),
                               [2, 3, 6, 4])


def test_torch_approx_equals_jax():
    a = np.array([1.0, 1.0 + 1e-6, 2.0, 1e-9, np.inf])
    b = np.array([1.0, 1.0, 2.1, 0.0, np.inf])
    for kw in ({}, {"rtol": 1e-7, "atol": 1e-12}):
        np.testing.assert_array_equal(tapprox.is_close(_t(a), _t(b), **kw).numpy(),
                                      np.asarray(japprox.is_close(a, b, **kw)))
    np.testing.assert_array_equal(
        tapprox.is_close_abs(_t(a), _t(b), atol=1e-6).numpy(),
        np.asarray(japprox.is_close_abs(a, b, atol=1e-6)))
    assert tapprox.sqr(3.0) == japprox.sqr(3.0) == 9.0


def test_torch_mean_std_streaming_equals_jax(rng):
    xs = rng.normal(loc=3.0, scale=2.0, size=500)
    s = tstats.mean_std_init(device="cpu")
    sj = jstats.mean_std_init(jnp.float64)
    assert s.mean.dtype == torch.float64 and s.n.dtype == torch.int32
    assert float(tstats.mean_std_result(s)[1]) == 0.0
    for x in xs:
        s = tstats.mean_std_update(s, x)
        sj = jstats.mean_std_update(sj, x)
    mean, std = tstats.mean_std_result(s)
    mj, sdj = jstats.mean_std_result(sj)
    np.testing.assert_allclose([float(mean), float(std)],
                               [float(mj), float(sdj)], rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(std), xs.std(ddof=1), atol=1e-9)


GJ_CASES = {
    "pivoting": np.hstack([np.array([[0.02, 0.01, 0, 0], [1, 2, 1, 0],
                                     [0, 1, 2, 1], [0, 0, 100, 200]]),
                           np.array([[0.02], [1], [4], [800]])]),
    "singular": np.array([[1.0, 3, 1, 9], [1, 1, -1, 1], [3, 11, 5, 35]]),
    "random": np.hstack([np.random.default_rng(1).normal(size=(7, 7)),
                         np.random.default_rng(2).normal(size=(7, 2))]),
    "tall": np.random.default_rng(3).normal(size=(6, 4)),
}


@pytest.mark.parametrize("name", sorted(GJ_CASES))
def test_torch_gauss_jordan_equals_jax(name):
    m = GJ_CASES[name]
    rref, ok = tla.gauss_jordan(_t(m))
    rj, okj = jla.gauss_jordan(jnp.asarray(m))
    assert bool(ok) == bool(okj) == (name != "singular")
    if name != "singular":
        np.testing.assert_allclose(rref.numpy(), np.asarray(rj), rtol=0,
                                   atol=1e-12)
    if name == "pivoting":
        np.testing.assert_allclose(rref[:, 4].numpy(), [1, 0, 0, 4], atol=1e-12)


def _fn_t(x):
    return torch.stack([x[0] + 0.1 * x[1] ** 2, torch.sin(x[1]) + x[0] * 0.2])


def _fn_j(x):
    return jnp.array([x[0] + 0.1 * x[1] ** 2, jnp.sin(x[1]) + x[0] * 0.2])


def test_torch_rand_equals_jax_given_draws(key):
    """The JAX package's standard normal draws handed to the port: the same
    samples and Monte-Carlo covariance; the Jacobian propagation equal."""
    cov = np.array([[2.0, 0.5], [0.5, 1.0]])
    mean = np.array([1.0, -1.0])
    n = 20_000
    white = np.array(jax.random.normal(key, (n, 2), dtype=jnp.float64))
    ref = np.asarray(jrand.sample_from_covariance(key, jnp.asarray(mean),
                                                  jnp.asarray(cov), n))
    out = trand.sample_from_covariance(_t(mean), _t(cov), white=_t(white))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(trand.calc_covar_mat(out).numpy(),
                               np.asarray(jrand.calc_covar_mat(jnp.asarray(ref))),
                               rtol=0, atol=1e-12)
    m2, c2 = np.array([0.5, 0.3]), np.diag([1e-4, 4e-4])
    ym, cm = jrand.propagate_uncertainty_mc(key, _fn_j, jnp.asarray(m2),
                                            jnp.asarray(c2), n=n)
    yt, ct = trand.propagate_uncertainty_mc(_fn_t, _t(m2), _t(c2),
                                            white=_t(white))
    np.testing.assert_allclose(yt.numpy(), np.asarray(ym), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cm), rtol=0, atol=1e-12)
    yj, cj = jrand.propagate_uncertainty_jacobian(_fn_j, jnp.asarray(m2),
                                                  jnp.asarray(c2))
    y, c = trand.propagate_uncertainty_jacobian(_fn_t, _t(m2), _t(c2))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=1e-15)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0, atol=1e-15)


def test_torch_rand_own_generator():
    """The port's own draws: test_sample_covariance_recovered and
    test_mc_vs_jacobian_propagation's checks."""
    g = torch.Generator().manual_seed(0)
    cov, mean = _t([[2.0, 0.5], [0.5, 1.0]]), _t([1.0, -1.0])
    s = trand.sample_from_covariance(mean, cov, 200_000, generator=g)
    np.testing.assert_allclose(s.mean(0).numpy(), mean.numpy(), atol=2e-2)
    np.testing.assert_allclose(trand.calc_covar_mat(s).numpy(), cov.numpy(),
                               atol=3e-2)
    m2, c2 = _t([0.5, 0.3]), torch.diag(_t([1e-4, 4e-4]))
    _, cov_mc = trand.propagate_uncertainty_mc(_fn_t, m2, c2, 200_000,
                                               generator=g)
    _, cov_j = trand.propagate_uncertainty_jacobian(_fn_t, m2, c2)
    np.testing.assert_allclose(cov_mc.numpy(), cov_j.numpy(), rtol=0.05,
                               atol=1e-8)
    with pytest.raises(ValueError):
        trand.sample_from_covariance(mean, cov, 5)


def test_torch_profiling_hooks(tmp_path):
    t = tprof.FrameTimer()
    assert t.last_ms == 0.0 and t.avg_ms == 0.0 and t.fps == 0.0
    for _ in range(3):
        with t:
            time.sleep(0.002)
    assert len(t.durations) == 3 and t.last_ms >= 2.0 and t.avg_ms >= 2.0
    assert t.format_line().startswith("track=") and t.fps > 0
    with tprof.device_trace(str(tmp_path), device="cpu"):
        with tprof.annotate("frame_0"):
            torch.ones(8).sum()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces
    with open(os.path.join(tmp_path, traces[0])) as fh:
        assert "frame_0" in fh.read()


def _jax_state():
    st = j_init_state(8, cam_pos=(0.1, 0.2, 0.3), cam_vel=(0.01, 0, 0),
                      cam_pos_std=0.05, dtype=jnp.float64)
    return st._replace(frame_ind=st.frame_ind + 7,
                       lm_active=st.lm_active.at[2].set(True))


def test_torch_checkpoint_loads_a_jax_checkpoint(tmp_path):
    path = str(tmp_path / "jax.npz")
    jckpt.save_pytree(path, _jax_state())
    st = tckpt.load_pytree(path, t_init_state(8, device="cpu"))
    assert type(st).__name__ == "MonoSlamState"
    for f, a in zip(st._fields, _jax_state()):
        b = getattr(st, f)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.dtype == torch.as_tensor(np.array(a)).dtype, f
    assert st.lm_active.dtype == torch.bool and int(st.frame_ind) == 7


def test_torch_checkpoint_roundtrip(tmp_path):
    st = t_init_state(8, device="cpu")
    st = st._replace(x=st.x + 0.5, lm_unobserved=st.lm_unobserved + 3)
    tree = {"state": st, "extra": (torch.arange(4), None, [torch.eye(2)])}
    path = str(tmp_path / "sub" / "c.npz")
    tckpt.save_pytree(path, tree)
    assert os.listdir(tmp_path / "sub") == ["c.npz"]   # no temporary left
    out = tckpt.load_pytree(path, tree)
    for a, b in zip(tckpt._flatten(tree), tckpt._flatten(out)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert out["extra"][1] is None and isinstance(out["state"], type(st))
    # the port's file loads into the JAX package's state too
    jst = jckpt.load_pytree(str(tmp_path / "sub" / "c.npz"),
                            {"state": j_init_state(8, dtype=jnp.float64),
                             "extra": (jnp.arange(4), None, [jnp.eye(2)])})
    np.testing.assert_array_equal(np.asarray(jst["state"].x), st.x.numpy())
    with pytest.raises(ValueError):
        tckpt.load_pytree(path, (st, st))
