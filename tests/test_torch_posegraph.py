"""SE(3) and Sim(3) pose graphs of the PyTorch port against the JAX package,
in float64 on the CPU, on the inputs of tests/test_posegraph.py and
tests/test_sim3_posegraph.py: both LM loops (the host schedule and the
device-loop LM). Optimized poses (and scales) within 1e-9, graph errors
within rtol 1e-9 (atol 1e-18 at the optimum), residuals and Jacobians of
the linearization within 1e-12. The inconsistent graphs of
test_torch_corrupted_odometry_graphs_match_jax have flat optima and are
held to 1e-7."""

import jax
import numpy as np
import pytest
import torch

from surikatoko_tpu.models import posegraph as jpg
from surikatoko_tpu_torch.models import posegraph as tpg

from test_posegraph import circle_poses, rel
from test_sim3_posegraph import _ring_poses

torch.set_num_threads(2)
TOL = dict(rtol=0, atol=1e-9)
ERR_TOL = dict(rtol=1e-9, atol=1e-18)
RNG_SEED = 20260817          # tests/conftest.py's rng fixture


def _drift_graph(n, rot_noise, trn_noise, closures, seed=RNG_SEED):
    """test_posegraph.py's noisy odometry chain with exact closures."""
    rng = np.random.default_rng(seed)
    R_gt, t_gt = circle_poses(n)
    Rs, ts, edges = [R_gt[0]], [t_gt[0]], []
    from surikatoko_tpu.geom import so3
    import jax.numpy as jnp
    for k in range(1, n):
        rR, rt = rel(R_gt[k - 1], t_gt[k - 1], R_gt[k], t_gt[k])
        rR_n = np.asarray(so3.exp(jnp.asarray(
            rng.normal(scale=rot_noise, size=3)))) @ rR
        rt_n = rt + rng.normal(scale=trn_noise, size=3)
        Rs.append(Rs[-1] @ rR_n)
        ts.append(ts[-1] + Rs[-2] @ rt_n)
        edges.append((k - 1, k, rR_n, rt_n, 1.0))
    for (i, j, w) in closures:
        rR, rt = rel(R_gt[i], t_gt[i], R_gt[j], t_gt[j])
        edges.append((i, j, rR, rt, w))
    return np.stack(Rs), np.stack(ts), edges


def _far_graph():
    """test_posegraph.py::test_posegraph_converges_from_far_initialization."""
    from surikatoko_tpu.geom import so3
    import jax.numpy as jnp
    n = 10
    R_gt, t_gt = circle_poses(n, radius=3.0)
    edges = []
    for k in range(1, n):
        rR, rt = rel(R_gt[k - 1], t_gt[k - 1], R_gt[k], t_gt[k])
        edges.append((k - 1, k, rR, rt, 1.0))
    rR, rt = rel(R_gt[n - 1], t_gt[n - 1], R_gt[0], t_gt[0])
    edges.append((n - 1, 0, rR, rt, 5.0))
    Rs, ts = [R_gt[0]], [t_gt[0]]
    for k in range(1, n):
        off = np.asarray(so3.exp(jnp.asarray([0.0, 0.0, 0.15 * k])))
        Rs.append(off @ R_gt[k])
        ts.append(t_gt[k] + np.array([0.3 * k, -0.2 * k, 0.1 * k]))
    return np.stack(Rs), np.stack(ts), edges


def _exact_graph():
    n = 8
    R_gt, t_gt = circle_poses(n)
    edges = [(k - 1, k, *rel(R_gt[k - 1], t_gt[k - 1], R_gt[k], t_gt[k]), 1.0)
             for k in range(1, n)]
    return R_gt, t_gt, edges


SE3_CASES = {
    # name: (the graph's inputs, iters)
    "drift_24": (lambda: _drift_graph(24, 0.03, 0.05, (
        (23, 0, 2.0), (12, 0, 2.0), (18, 6, 2.0))), 25),
    "exact_8": (_exact_graph, 3),
    "far_init": (_far_graph, 40),
}


def _scale_drift(n=24):
    """test_sim3_posegraph.py's ring with compounding 2% scale drift."""
    R_gt, t_gt = _ring_poses(n)
    R0, t0 = [R_gt[0]], [t_gt[0]]
    for k in range(n - 1):
        rel_R = R_gt[k].T @ R_gt[k + 1]
        rel_t = R_gt[k].T @ (t_gt[k + 1] - t_gt[k]) * (1.02 ** (k + 1))
        R0.append(R0[-1] @ rel_R)
        t0.append(t0[-1] + R0[-2] @ rel_t)
    return R_gt, t_gt, np.stack(R0), np.stack(t0)


def _sim3_ring_graph():
    R_gt, t_gt, R0, t0 = _scale_drift()
    n = len(R_gt)
    edges = [(k, k + 1, R_gt[k].T @ R_gt[k + 1],
              R_gt[k].T @ (t_gt[k + 1] - t_gt[k]), 1.0, 1.0)
             for k in range(n - 1)]
    for j in (0, 1):
        Z = jpg.sim3_compose(jpg.sim3_inverse((1.0, R_gt[n - 1], t_gt[n - 1])),
                             (1.0, R_gt[j], t_gt[j]))
        edges.append((n - 1, j, Z[1], Z[2], Z[0], 5.0))
    return R0, t0, edges


def _corrupted_odometry():
    """test_se3_graph_cannot_fix_scale_drift: the odometry as the drifted
    chain measured it, one closure with its scale unmeasured; (SE(3) edges,
    Sim(3) edges)."""
    R_gt, t_gt, R0, t0 = _scale_drift()
    n = len(R_gt)
    edges = [(k, k + 1, R_gt[k].T @ R_gt[k + 1],
              R_gt[k].T @ (t_gt[k + 1] - t_gt[k]) * (1.02 ** (k + 1)), 1.0)
             for k in range(n - 1)]
    edges.append((n - 1, 0, R_gt[n - 1].T @ R_gt[0],
                  R_gt[n - 1].T @ (t_gt[0] - t_gt[n - 1]), 5.0))
    return R0, t0, edges, [(e[0], e[1], e[2], e[3], 1.0, e[4]) for e in edges]


def _np(g):
    return {k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in g._asdict().items()}


@pytest.mark.parametrize("case", sorted(SE3_CASES))
@pytest.mark.parametrize("device_loop", [False, True])
def test_torch_pose_graph_matches_jax(case, device_loop):
    build, iters = SE3_CASES[case]
    R0, t0, edges = build()
    gj = jpg.make_pose_graph(R0, t0, edges)
    gt = tpg.make_pose_graph(R0, t0, edges, device="cpu")
    for k, v in _np(gt).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(gj, k)), err_msg=k)
    np.testing.assert_allclose(float(tpg.graph_error(gt)),
                               float(jpg.graph_error(gj)), **ERR_TOL)
    oj = jpg.optimize_pose_graph(gj, iters=iters, device_loop=device_loop)
    ot = tpg.optimize_pose_graph(gt, iters=iters, device_loop=device_loop)
    np.testing.assert_allclose(ot.R.numpy(), np.asarray(oj.R), **TOL)
    np.testing.assert_allclose(ot.t.numpy(), np.asarray(oj.t), **TOL)
    np.testing.assert_allclose(float(tpg.graph_error(ot)),
                               float(jpg.graph_error(oj)), **ERR_TOL)
    # the gauge: pose 0 exactly where it was
    np.testing.assert_array_equal(ot.t[0].numpy(), t0[0])


def test_torch_pose_graph_linearization_matches_jax():
    """Residuals and the jacfwd Jacobian at a drifted chain (pose-0 columns
    zeroed), and one damped step."""
    R0, t0, edges = SE3_CASES["drift_24"][0]()
    gj = jpg.make_pose_graph(R0, t0, edges)
    gt = tpg.make_pose_graph(R0, t0, edges, device="cpu")
    rj, Jj = jax.jit(jpg._linearize)(gj)
    rt, Jt = tpg._linearize(gt)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=0, atol=1e-12)
    dj = jpg._solve_damped(gj, (rj, Jj), 1e-3)
    dt = tpg._solve_damped((rt, Jt), 1e-3, sim3=False)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-12)


@pytest.mark.parametrize("device_loop", [False, True])
def test_torch_sim3_graph_ring_matches_jax(device_loop):
    R0, t0, edges = _sim3_ring_graph()
    gj = jpg.make_sim3_graph(R0, t0, edges)
    gt = tpg.make_sim3_graph(R0, t0, edges, device="cpu")
    for k, v in _np(gt).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(gj, k)), err_msg=k)
    np.testing.assert_allclose(float(tpg.sim3_graph_error(gt)),
                               float(jpg.sim3_graph_error(gj)), **ERR_TOL)
    oj = jpg.optimize_sim3_graph(gj, iters=50, device_loop=device_loop)
    ot = tpg.optimize_sim3_graph(gt, iters=50, device_loop=device_loop)
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(ot, k).numpy(),
                                   np.asarray(getattr(oj, k)), **TOL)
    np.testing.assert_allclose(float(tpg.sim3_graph_error(ot)),
                               float(jpg.sim3_graph_error(oj)), **ERR_TOL)
    R_gt, t_gt = _ring_poses(24)
    np.testing.assert_allclose(ot.t.numpy(), t_gt, atol=1e-5)
    np.testing.assert_allclose(ot.s.numpy(), 1.0, atol=1e-6)


def test_torch_sim3_linearization_matches_jax():
    R0, t0, edges = _sim3_ring_graph()
    gj = jpg.make_sim3_graph(R0, t0, edges)
    gt = tpg.make_sim3_graph(R0, t0, edges, device="cpu")
    rj, Jj = jax.jit(jpg._sim3_linearize)(gj)
    rt, Jt = tpg._sim3_linearize(gt)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=0, atol=1e-12)
    dj = jpg._sim3_solve_damped(gj, (rj, Jj), 1e-3)
    dt = tpg._solve_damped((rt, Jt), 1e-3, sim3=True)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-12)


@pytest.mark.parametrize("device_loop", [False, True])
def test_torch_corrupted_odometry_graphs_match_jax(device_loop):
    """The SE(3) control and the Sim(3) graph on the same scale-corrupted
    odometry (test_se3_graph_cannot_fix_scale_drift's 50 and 60
    iterations): each as the JAX package's, and Sim(3) closer to the GT
    ring. The optima of these inconsistent edges are flat, so rounding
    alone moves them by orders more than the consistent graphs' (in either
    package, under a 1e-15 change of the input): held to 1e-7."""
    from surikatoko_tpu_torch.geom.align import aligned_rmse
    R0, t0, e_se3, e_sim3 = _corrupted_odometry()
    flat = dict(rtol=0, atol=1e-7)
    oj = jpg.optimize_pose_graph(jpg.make_pose_graph(R0, t0, e_se3), iters=50,
                                 device_loop=device_loop)
    ot = tpg.optimize_pose_graph(tpg.make_pose_graph(R0, t0, e_se3,
                                                     device="cpu"),
                                 iters=50, device_loop=device_loop)
    np.testing.assert_allclose(ot.t.numpy(), np.asarray(oj.t), **flat)
    np.testing.assert_allclose(ot.R.numpy(), np.asarray(oj.R), **flat)
    np.testing.assert_allclose(float(tpg.graph_error(ot)),
                               float(jpg.graph_error(oj)), **ERR_TOL)
    sj = jpg.optimize_sim3_graph(jpg.make_sim3_graph(R0, t0, e_sim3),
                                 iters=60, device_loop=device_loop)
    st = tpg.optimize_sim3_graph(tpg.make_sim3_graph(R0, t0, e_sim3,
                                                     device="cpu"),
                                 iters=60, device_loop=device_loop)
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(sj, k)), **flat)
    _, t_gt = _ring_poses(24)
    t_gt = torch.as_tensor(t_gt)
    assert float(aligned_rmse(st.t, t_gt)) < 0.8 * float(aligned_rmse(ot.t, t_gt))


def test_torch_sim3_compose_inverse_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    from surikatoko_tpu.geom import so3
    import jax.numpy as jnp
    a = (1.7, np.asarray(so3.exp(jnp.asarray(rng.normal(size=3) * 0.3))),
         rng.normal(size=3))
    b = (0.6, np.asarray(so3.exp(jnp.asarray(rng.normal(size=3) * 0.5))),
         rng.normal(size=3))
    for out_t, out_j in ((tpg.sim3_compose(a, b), jpg.sim3_compose(a, b)),
                         (tpg.sim3_inverse(a), jpg.sim3_inverse(a))):
        for x, y in zip(out_t, out_j):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
