"""The device-loop LM's CUDA graphs on the card (``utils/cuda_graph``): a
one-problem run on a card replays a graph of the Gauss-Newton blocks and
one of the damped trial (solve, apply, evaluate), held to the same run
without graphs (``cuda_graph.graphable`` patched to refuse): the same stop
code, iterations and trials, and parameters within tolerance (on the card
``index_add_`` sums with atomics, so two eager runs may already differ in
their last bits). The cases: a windowed-shape sparse BA (25 frames, two
pinned, full width), a global-shape one (banded, normalized, pad frames
pinned), a dense BA, and the Sim(3) pose graph, in float32 and float64; a
second run at one key captures nothing; capture and replay make no host
sync but the trial's one fetch; a batched LM never engages a graph.
Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_lm_graph_cuda.py -m cuda -q

Without a CUDA device every case skips."""

import contextlib

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch.geom import so3
from surikatoko_tpu_torch.interop import stack
from surikatoko_tpu_torch.models import posegraph
from surikatoko_tpu_torch.models.ba import (BundleAdjustment,
                                            SparseBundleAdjustment,
                                            TermCriteria, lm_device,
                                            reproj_error)
from surikatoko_tpu_torch.models.ba import sparse as sp
from surikatoko_tpu_torch.utils import cuda_graph
from surikatoko_tpu_torch.utils.profiling import counts
from surikatoko_tpu_torch.world.ba_scene import (build_at_scale_problem,
                                                 circle_grid_problem)

# largest |graphed - eager| over the largest |eager| of a parameter, and
# the final errors' relative difference: two eager runs differ by the
# atomics' rounding, which the reduced system's weak modes amplify
TOL = {torch.float32: 1e-2, torch.float64: 1e-6}
ERR_RTOL = {torch.float32: 1e-4, torch.float64: 1e-9}
DTYPES = [torch.float32, torch.float64]
N_PAD = 8          # the global shape's pad frames (no observations, pinned)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LM's graphs run only on a card")
    from surikatoko_tpu_torch import config
    config.set_full_precision()
    return torch.device("cuda", 0)


def _counts(name):
    c = counts()
    return {k: c.get(f"{name}.{k}", 0) for k in
            ("graph_captures", "graph_replays", "iterations", "trials")}


def _delta(before, name):
    after = _counts(name)
    return {k: after[k] - before[k] for k in after}


@contextlib.contextmanager
def _eager(monkeypatch):
    """The same runs with no graph."""
    with monkeypatch.context() as m:
        m.setattr(cuda_graph, "graphable", lambda tensors: False)
        yield


@contextlib.contextmanager
def _no_sync(monkeypatch):
    """Any synchronizing CUDA call inside raises, but the LM's fetch."""
    fetch = lm_device._fetch

    def allowed(a, b):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fetch(a, b)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    torch.cuda.synchronize()
    with monkeypatch.context() as m:
        m.setattr(lm_device, "_fetch", allowed)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _at_scale(n_points, n_frames, L, dev, dtype, seed):
    """The ring world with its points moved by 0.1 (~6 px), so that each
    of the first LM steps lowers the error far above its rounding."""
    p, fidx, mask = build_at_scale_problem(n_points, n_frames, L,
                                           noise_pix=0.5, seed=seed,
                                           dtype=dtype, device=dev)
    g = torch.Generator().manual_seed(seed)
    move = 0.1 * torch.randn(p.points.shape, generator=g, dtype=torch.float64)
    return p._replace(points=p.points + move.to(dev, dtype)), fidx, mask


def _window(dev, dtype, seed=0):
    """The windowed BA's shape: 512 points, 25 frames, tracks of 16, the
    two oldest frames pinned, full width, no normalization."""
    return _at_scale(512, 25, 16, dev, dtype, seed)[0], None


def _global(dev, dtype, seed=0):
    """The global BA's shape: 2048 points, 100 frames of which the last
    N_PAD carry no observation and are pinned, tracks of 6, banded,
    normalized."""
    p, fidx, mask = _at_scale(2048, 100, 6, dev, dtype, seed)
    mask = mask & (fidx < 100 - N_PAD)
    return p._replace(obs_mask=torch.as_tensor(mask, device=dev)), (fidx, mask)


def _dense(dev, dtype, seed=0):
    p, _, _ = circle_grid_problem(noise_pnt=0.05, noise_rot=0.02,
                                  rng=np.random.default_rng(seed),
                                  dtype=dtype, device=dev)
    return p, None


# shape: (problem, its BA, the BA's entry point, the problem's error)
SHAPES = {
    "window": (_window, lambda: SparseBundleAdjustment(
        optimize_intrinsics=False, pin_frames=(0, 1), point_chunk=512,
        band=False, device_loop=True), "compute", sp.reproj_error),
    # the gauge's unity component: the cam0-cam1 shift lies along x
    "global": (_global, lambda: SparseBundleAdjustment(
        optimize_intrinsics=False, pin_frames=tuple(range(100 - N_PAD, 100)),
        unity_comp_ind=0, point_chunk=512, device_loop=True),
        "compute_inplace", sp.reproj_error),
    "dense": (_dense, lambda: BundleAdjustment(device_loop=True),
              "compute_inplace", reproj_error),
}
# steps that each lower the error far above its rounding (float32 reaches
# its floor at the third): near convergence the atomics' rounding alone
# could flip a trial's accept in either run
MAX_ITERS = {torch.float32: 2, torch.float64: 3}


def _run(ba, entry, problem, dtype):
    """``ba``'s entry point on ``problem`` = (p, band plan inputs)."""
    p, inputs = problem
    if inputs is not None:
        ba.set_plan_inputs(*inputs)
    return getattr(ba, entry)(p, TermCriteria(
        allowed_reproj_err_rel_change=None, max_iters=MAX_ITERS[dtype]))


def _assert_close(got, want, dtype, names=("points", "cfw_R", "cfw_t")):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        rel = float((a - b).abs().max()) / float(b.abs().max())
        assert rel <= TOL[dtype], (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_torch_graphed_ba_takes_the_eager_path(shape, dtype, monkeypatch):
    """Graphed and eager: the same stop reason, iterations and trials; the
    graphed run captures two graphs and replays one a blocks call and one
    a trial."""
    dev = _card()
    build, make_ba, entry, err = SHAPES[shape]
    problem = build(dev, dtype)
    ba = make_ba()
    c0 = _counts("ba")
    ok, got = _run(ba, entry, problem, dtype)
    path = (ok, ba.stop_reason, ba.iterations, ba.trials)
    d = _delta(c0, "ba")
    assert d["graph_captures"] == 2
    assert d["graph_replays"] >= ba.iterations + ba.trials
    with _eager(monkeypatch):
        c0 = _counts("ba")
        ok_e, want = _run(ba, entry, problem, dtype)
        assert _delta(c0, "ba")["graph_replays"] == 0
    assert path == (ok_e, ba.stop_reason, ba.iterations, ba.trials)
    assert (ok, ba.iterations) == (True, MAX_ITERS[dtype])
    np.testing.assert_allclose(float(err(got)), float(err(want)),
                               rtol=ERR_RTOL[dtype])
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["window", "global"])
def test_torch_second_run_at_one_key_only_replays(shape):
    """Two runs of one BA object on two problems of one shape: the first
    captures the blocks and the trial graph, the second only replays them
    (a global BA plans its bands anew for a new problem, so it captures
    again); what the first run returned is left as it was."""
    dev = _card()
    build, make_ba, entry, _ = SHAPES[shape]
    ba = make_ba()
    c0 = _counts("ba")
    _, out1 = _run(ba, entry, build(dev, torch.float32, seed=1),
                   torch.float32)
    kept = [t.clone() for t in out1]
    assert _delta(c0, "ba")["graph_captures"] == 2
    c1 = _counts("ba")
    _, out2 = _run(ba, entry, build(dev, torch.float32, seed=2),
                   torch.float32)
    d = _delta(c1, "ba")
    assert d["graph_captures"] == (2 if shape == "global" else 0)
    assert d["graph_replays"] >= ba.iterations + ba.trials
    for a, b in zip(out1, kept):
        assert torch.equal(a, b)
    assert not ({t.data_ptr() for t in out1[:3]}
                & {t.data_ptr() for t in out2})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", ["window", "global"])
def test_torch_lm_graphs_make_no_host_sync_but_the_fetch(shape, dtype,
                                                         monkeypatch):
    """The LM of a planned sparse BA under set_sync_debug_mode("error"),
    its fetch a trial let through: capture (first run) and replay (second
    run) make no other host sync."""
    dev = _card()
    build, make_ba, _, _ = SHAPES[shape]
    (p, inputs), ba = build(dev, dtype), make_ba()
    if inputs is not None:
        ba.set_plan_inputs(*inputs)
    ba._plan_band(p)
    assert (ba._plan is not None) == (shape == "global")
    fns = dict(zip(("blocks_fn", "solve_fn", "apply_fn", "err_fn"),
                   ba._fns(p)))
    kw = dict(err_thresh=None, max_factor=1e12, max_iters=MAX_ITERS[dtype],
              graphs=ba._graphs, **fns)
    c0 = _counts("ba")
    for _ in range(2):
        with _no_sync(monkeypatch):
            _, code, iters, _, _ = lm_device.run_lm_on_device(p, **kw)
        assert (code, iters) == (lm_device.STOP_MAX_ITERS, MAX_ITERS[dtype])
    assert _delta(c0, "ba")["graph_captures"] == 2


def _sim3_ring(n=40, drift=1.01):
    """A ring of n keyframes whose odometry drifted in scale (each step
    ``drift`` times the last) and two closure edges from the last node
    to the first two, measured from the true poses."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    R_gt = np.stack([so3.exp(torch.tensor([0.0, 0.0, a], dtype=torch.float64))
                     .numpy() for a in ang])
    t_gt = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0.1 * np.sin(3 * ang)],
                    axis=1)
    R0, t0 = [R_gt[0]], [t_gt[0]]
    for k in range(n - 1):
        step = R_gt[k].T @ (t_gt[k + 1] - t_gt[k]) * drift ** (k + 1)
        R0.append(R0[-1] @ (R_gt[k].T @ R_gt[k + 1]))
        t0.append(t0[-1] + R0[-2] @ step)
    edges = [(k, k + 1, R_gt[k].T @ R_gt[k + 1],
              R_gt[k].T @ (t_gt[k + 1] - t_gt[k]), 1.0, 1.0)
             for k in range(n - 1)]
    for j in (0, 1):
        Z = posegraph.sim3_compose(
            posegraph.sim3_inverse((1.0, R_gt[n - 1], t_gt[n - 1])),
            (1.0, R_gt[j], t_gt[j]))
        edges.append((n - 1, j, Z[1], Z[2], Z[0], 5.0))
    return np.stack(R0), np.stack(t0), edges


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_torch_graphed_sim3_pose_graph_equals_eager(dtype, monkeypatch):
    """The closure's Sim(3) pose graph: graphed, with its linearization
    and trials replayed under set_sync_debug_mode("error") but the fetch,
    against its eager run: the same iterations and trials, poses and
    scales within tolerance, and a graph error that fell."""
    dev = _card()
    R0, t0, edges = _sim3_ring()
    g = posegraph.make_sim3_graph(R0, t0, edges, device=dev, dtype=dtype)
    c0 = _counts("posegraph")
    with _no_sync(monkeypatch):
        got = posegraph.optimize_sim3_graph(g, iters=30, device_loop=True)
    d = _delta(c0, "posegraph")
    assert d["graph_captures"] == 2
    assert d["graph_replays"] >= d["iterations"] + d["trials"]
    with _eager(monkeypatch):
        c0 = _counts("posegraph")
        want = posegraph.optimize_sim3_graph(g, iters=30, device_loop=True)
        e = _delta(c0, "posegraph")
    assert e["graph_replays"] == 0
    assert (d["iterations"], d["trials"]) == (e["iterations"], e["trials"])
    _assert_close(got, want, dtype, names=("R", "t", "s"))
    err = float(posegraph.sim3_graph_error(got))
    assert err < 1e-2 * float(posegraph.sim3_graph_error(g))
    np.testing.assert_allclose(err, float(posegraph.sim3_graph_error(want)),
                               rtol=ERR_RTOL[dtype] * 100, atol=1e-12)


@pytest.mark.cuda
def test_torch_batched_lm_engages_no_graph():
    """run_lm_on_device_batched (BundleAdjustment.compute_batched) on the
    card stays eager: it counts no graph capture or replay."""
    dev = _card()
    probs = [circle_grid_problem(noise_pnt=0.05, noise_rot=0.02,
                                 rng=np.random.default_rng(s),
                                 dtype=torch.float64, device=dev)[0]
             for s in (1, 2)]
    c0 = _counts("ba")
    r = BundleAdjustment(device_loop=True).compute_batched(
        stack(probs), TermCriteria(max_iters=3))
    d = _delta(c0, "ba")
    assert (d["graph_captures"], d["graph_replays"]) == (0, 0)
    assert d["trials"] == int(r.trials.sum()) > 0
