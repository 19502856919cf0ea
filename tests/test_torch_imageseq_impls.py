"""The ported image-sequence loop with the sequential update impls 2 and 3
against the JAX package, in float64 on the CPU, on
tests/test_device_runner.py::test_imageseq_runner_impl_2_3's inputs
(capacity 16, grid world, 20 frames; JAX with its XLA NCC surface): per-frame
matched counts equal, camera positions within 1e-6 (the slice's pin in
tests/test_torch_slice.py: the port's search takes the kernel's f32
surface)."""

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
CAPACITY = 16
FRAMES = 20


@pytest.fixture(scope="module")
def imageseq16():
    dtype = jnp.float64
    sc = jdr.build_imageseq_scenario(capacity=CAPACITY, dtype=dtype)
    cam = jcam.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                               (0.01, 0.01), dtype=dtype)
    params = j_make_params(cam, None, dt=1.0,
                           process_noise_lin_veloc_std=0.075,
                           process_noise_ang_veloc_std=0.01, dtype=dtype)
    st, templates = jdr.init_imageseq(params, sc,
                                      j_init_state(CAPACITY, dtype=dtype), 15)
    return params, sc, st, templates


@pytest.mark.parametrize("impl", [2, 3])
def test_torch_imageseq_runner_impls_2_3_match_jax(imageseq16, impl):
    params, sc, st, templates = imageseq16
    run_j = jdr.make_imageseq_scan_runner(params, use_pallas=False,
                                          update_impl=impl)
    _, (errs_j, n_j, pos_j) = run_j(st, templates, sc,
                                    jnp.arange(1, 1 + FRAMES))
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    run_t = tdr.make_imageseq_scan_runner(
        interop.params_from_numpy(np_(params)), update_impl=impl)
    st_t, (errs_t, n_t, pos_t, info_t) = run_t(
        interop.state_from_numpy(np_(st)), interop.templates_from_numpy(
            np.asarray(templates)), interop.scenario_from_numpy(np_(sc)),
        range(1, 1 + FRAMES))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert n_t.numpy()[:10].min() > CAPACITY * 3 // 4
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(errs_t.numpy(), np.asarray(errs_j), rtol=1e-5,
                               atol=1e-6)
    assert int(torch.count_nonzero(info_t)) == 0
    assert bool(torch.isfinite(st_t.P).all())
