"""The ported image-sequence closed loop against the JAX reference, end to
end in float64 on the CPU: the flagship runner (recruitment, local depth
prior, delete-unobserved) and its no-recruit control, at test size, from the
same scenario, parameters and bootstrap state."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.models.monoslam import init_state as j_init_state
from surikatoko_tpu.models.monoslam import make_params as j_make_params
from surikatoko_tpu.world import device_runner as jdr
from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.world import device_runner as tdr

torch.set_num_threads(2)

FRAMES = 20


@pytest.fixture(scope="module")
def slice_setup():
    """The configuration of tests/test_recruit_fused.py::_run_local_churn:
    K=24, 320x240, grid world, f64; both sides start from the JAX
    bootstrap state and templates."""
    dtype = jnp.float64
    sc = jdr.build_imageseq_scenario(capacity=24, n_points=24, dtype=dtype,
                                     image_size=(320, 240), bg_cell=32,
                                     max_deviation=1.0, world="grid")
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                               (0.01, 0.01), dtype=dtype)
    params = j_make_params(cam, None, dt=1.0,
                           process_noise_lin_veloc_std=0.075,
                           process_noise_ang_veloc_std=0.01,
                           sal_pnt_init_inv_dist=0.5,
                           sal_pnt_init_inv_dist_std=0.5,
                           max_undetected_frames=8, dtype=dtype)
    st, templates = jax.jit(lambda s: jdr.init_imageseq(
        params, sc, s, 15, max_bootstrap=20))(j_init_state(24, dtype=dtype))
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    torch_side = (interop.params_from_numpy(np_(params), device="cpu"),
                  interop.scenario_from_numpy(np_(sc), device="cpu"),
                  interop.state_from_numpy(np_(st), device="cpu"),
                  interop.templates_from_numpy(np.asarray(templates), device="cpu"))
    return (params, sc, st, templates), torch_side


def test_torch_init_imageseq_matches_jax(slice_setup):
    (params, sc, _, _), (tp, tsc, _, _) = slice_setup
    st_j, tm_j = jdr.init_imageseq(params, sc, j_init_state(24), 15,
                                   max_bootstrap=20)
    st_t, tm_t = tdr.init_imageseq(
        tp, tsc, interop.state_from_numpy(
            jax.tree_util.tree_map(np.asarray, j_init_state(24)), device="cpu"),
        15, max_bootstrap=20)
    np.testing.assert_array_equal(st_t.lm_active.numpy(),
                                  np.asarray(st_j.lm_active))
    np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st_t.P.numpy(), np.asarray(st_j.P),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tm_t.numpy(), np.asarray(tm_j),
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("recruit", [True, False])
def test_torch_imageseq_loop_matches_jax(slice_setup, recruit):
    """Per-frame matched (and, with recruitment, recruited and active)
    counts equal; camera positions within 1e-6. The port's search takes the
    kernel's f32 surface (as the JAX Pallas path does) while the JAX
    reference here takes its f64 XLA surface: integer match centers agree
    unless two cells tie within f32 rounding, which these frames do not
    show."""
    (params, sc, st, templates), (tp, tsc, tst, ttm) = slice_setup
    kw = dict(templ_width=15, search_radius=9, recruit=recruit,
              recruit_max=4, recruit_depth="local")
    run_j = jdr.make_imageseq_scan_runner(params, use_pallas=False, **kw)
    run_t = tdr.make_imageseq_scan_runner(tp, **kw)
    frames = range(1, 1 + FRAMES)
    out_j = run_j(st, templates, sc, jnp.arange(1, 1 + FRAMES))[-1]
    res_t = run_t(tst, ttm, tsc, frames)
    out_t = res_t[-1]
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]),
                               atol=1e-6)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               rtol=1e-5, atol=1e-6)
    assert int(torch.count_nonzero(out_t[-1])) == 0   # every Cholesky held
    if recruit:
        np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
        np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
        assert int(out_t[3].sum()) > 0
    P = res_t[0].P
    assert torch.equal(P, P.T)


def test_torch_imageseq_target_active_matches_jax(slice_setup):
    """The recruit budget target_active (JAX device_runner.py:336-340):
    per-frame recruited and active counts equal to JAX's, camera positions
    within 1e-6, and no frame that recruits ends above the target."""
    (params, sc, st, templates), (tp, tsc, tst, ttm) = slice_setup
    target = 16
    kw = dict(templ_width=15, search_radius=9, recruit=True, recruit_max=4,
              recruit_depth="local", target_active=target)
    out_j = jdr.make_imageseq_scan_runner(params, use_pallas=False, **kw)(
        st, templates, sc, jnp.arange(1, 1 + FRAMES))[-1]
    out_t = tdr.make_imageseq_scan_runner(tp, **kw)(
        tst, ttm, tsc, range(1, 1 + FRAMES))[-1]
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]), atol=1e-6)
    n_rec, n_act = out_t[3].numpy(), out_t[4].numpy()
    assert n_rec.sum() > 0
    assert ((n_rec == 0) | (n_act <= target)).all()


@pytest.mark.parametrize("impl", [2, 3, 4])
def test_torch_runner_recruitment_requires_impl_1(slice_setup, impl):
    """As in JAX (device_runner.py:260-261): impls 2-4 run, but only the
    fused step recruits."""
    _, (tp, _, _, _) = slice_setup
    with pytest.raises(ValueError, match="requires update_impl=1"):
        tdr.make_imageseq_scan_runner(tp, recruit=True, update_impl=impl)
    tdr.make_imageseq_scan_runner(tp, update_impl=impl)


def test_torch_package_never_imports_jax():
    code = ("import sys, surikatoko_tpu_torch, surikatoko_tpu_torch.world."
            "device_runner, surikatoko_tpu_torch.interop, "
            "surikatoko_tpu_torch.models.ba, surikatoko_tpu_torch.io.dino, "
            "surikatoko_tpu_torch.world.ba_scene, "
            "surikatoko_tpu_torch.models.monoslam.filter, "
            "surikatoko_tpu_torch.models.monoslam.health, "
            "surikatoko_tpu_torch.world.demo_matcher, "
            "surikatoko_tpu_torch.world.runner, "
            "surikatoko_tpu_torch.world.scene_gen, "
            "surikatoko_tpu_torch.geom.align, surikatoko_tpu_torch.geom.so3, "
            "surikatoko_tpu_torch.geom.quat, surikatoko_tpu_torch.geom.se3, "
            "surikatoko_tpu_torch.geom.ellipse, surikatoko_tpu_torch.vision.klt, "
            "surikatoko_tpu_torch.vision.matcher, "
            "surikatoko_tpu_torch.vision.picture, "
            "surikatoko_tpu_torch.io.frame_loader, "
            "surikatoko_tpu_torch.io.tracker_log, "
            "surikatoko_tpu_torch.models.mvf, "
            "surikatoko_tpu_torch.models.mvf.relative_motion, "
            "surikatoko_tpu_torch.models.mvf.factorizer, "
            "surikatoko_tpu_torch.models.posegraph, "
            "surikatoko_tpu_torch.ops.transfer, "
            "surikatoko_tpu_torch.demos.multi_view_factorization, "
            "surikatoko_tpu_torch.demos.mvf_at_scale; "
            "bad = sorted(m for m in sys.modules "
            "if m in ('jax', 'surikatoko_tpu') "
            "or m.startswith(('jax.', 'surikatoko_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": os.path.dirname(os.path.dirname(
               os.path.abspath(__file__)))}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
