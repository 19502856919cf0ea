"""Geometry and scenario builders of the PyTorch port against the JAX
package, in float64, to 1e-12: the same numpy inputs go through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surikatoko_tpu.geom import align as jalign
from surikatoko_tpu.geom import camera as jcam
from surikatoko_tpu.geom import quat as jquat
from surikatoko_tpu.geom import se3 as jse3
from surikatoko_tpu.world import device_runner as jdr
from surikatoko_tpu.world import runner as jrunner
from surikatoko_tpu.world import scene_gen as jscene
from surikatoko_tpu_torch.geom import align as talign
from surikatoko_tpu_torch.geom import camera as tcam
from surikatoko_tpu_torch.geom import quat as tquat
from surikatoko_tpu_torch.geom import se3 as tse3
from surikatoko_tpu_torch.world import device_runner as tdr
from surikatoko_tpu_torch.world import runner as trunner
from surikatoko_tpu_torch.world import scene_gen as tscene

torch.set_num_threads(2)
TOL = dict(rtol=1e-12, atol=1e-12)


def _pair(a):
    a = np.asarray(a, np.float64)
    return jnp.asarray(a), torch.as_tensor(a)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


def test_torch_quat_ops(rng):
    qa_j, qa_t = _pair(rng.normal(size=(16, 4)))
    qb_j, qb_t = _pair(rng.normal(size=(16, 4)))
    _close(tquat.mult(qa_t, qb_t), jquat.mult(qa_j, qb_j))
    _close(tquat.to_rotmat(qa_t / torch.linalg.norm(qa_t, dim=-1, keepdim=True)),
           jquat.to_rotmat(jquat.normalize(qa_j)))
    # both branches of the small-angle switch
    w = np.concatenate([rng.normal(size=(8, 3)), 1e-6 * rng.normal(size=(8, 3)),
                        np.zeros((1, 3))])
    w_j, w_t = _pair(w)
    _close(tquat.from_axis_angle(w_t), jquat.from_axis_angle(w_j))


def test_torch_se3_and_look_at(rng):
    eye_j, eye_t = _pair(rng.normal(size=(6, 3)))
    c_j, c_t = _pair(rng.normal(size=(6, 3)) + 3.0)
    up_j, up_t = _pair(np.tile([0.0, 0.0, 1.0], (6, 1)))
    wj = jse3.look_at_luf_wfc(eye_j, c_j, up_j)
    wt = tse3.look_at_luf_wfc(eye_t, c_t, up_t)
    _close(wt.R, wj.R)
    _close(wt.t, wj.t)
    _close(wt.inv().R, wj.inv().R)
    _close(wt.inv().t, wj.inv().t)


@pytest.mark.parametrize("distorted", [False, True])
def test_torch_camera(rng, distorted):
    args = ((640, 480), (320.0, 240.0), 1.95, (0.005, 0.005))
    cj = jcam.make_intrinsics(*args, dtype=jnp.float64)
    ct = tcam.make_intrinsics(*args, dtype=torch.float64, device="cpu")
    dj = jcam.MikhailDistortion(jnp.asarray(0.3), jnp.asarray(0.05)) if distorted else None
    dt = tcam.MikhailDistortion(torch.tensor(0.3, dtype=torch.float64),
                                torch.tensor(0.05, dtype=torch.float64)) if distorted else None
    pts = rng.normal(size=(32, 3)) + np.array([0.0, 0.0, 4.0])
    p_j, p_t = _pair(pts)
    pix_j = jcam.project_camera_point(cj, dj, p_j)
    pix_t = tcam.project_camera_point(ct, dt, p_t)
    _close(pix_t, pix_j)
    _close(tcam.backproject_pixel(ct, dt, pix_t),
           jcam.backproject_pixel(cj, dj, pix_j))
    th_j, ph_j = jcam.azim_elev_from_dir(p_j)
    th_t, ph_t = tcam.azim_elev_from_dir(p_t)
    _close(th_t, th_j)
    _close(ph_t, ph_j)
    _close(tcam.dir_from_azim_elev(th_t, ph_t), jcam.dir_from_azim_elev(th_j, ph_j))


def test_torch_align_ate(rng):
    src = rng.normal(size=(40, 3))
    dst = 1.7 * src @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.3
    dst = dst + 0.01 * rng.normal(size=dst.shape)
    s_j, d_j = _pair(src)[0], _pair(dst)[0]
    s_t, d_t = _pair(src)[1], _pair(dst)[1]
    for a, b in zip(talign.umeyama_similarity(s_t, d_t),
                    jalign.umeyama_similarity(s_j, d_j)):
        _close(a, b, rtol=1e-10, atol=1e-12)
    _close(talign.aligned_rmse(s_t, d_t), jalign.aligned_rmse(s_j, d_j),
           rtol=1e-10, atol=1e-14)


def test_torch_scene_gen():
    wb = jscene.WorldBounds(0.0, 0.9, 0.0, 0.9, 0.0, 0.9001)
    _close(tscene.generate_grid_points(tscene.WorldBounds(*wb), (0.3, 0.3, 0.3), 0.2),
           jscene.generate_grid_points(wb, (0.3, 0.3, 0.3), 0.2))
    kw = dict(max_deviation=0.8, periods_count=2, shots_per_period=160)
    cj = jscene.oscillate_right_and_left((0.4, -2.0, 0.5), (0.4, 0.0, 0.5),
                                         (0, 0, 1), **kw)
    ct = tscene.oscillate_right_and_left((0.4, -2.0, 0.5), (0.4, 0.0, 0.5),
                                         (0, 0, 1), **kw)
    _close(ct.R, cj.R)
    _close(ct.t, cj.t)
    gj = jrunner.gt_poses_in_tracker_frame(cj)
    gt = trunner.gt_poses_in_tracker_frame(ct)
    _close(gt.R, gj.R)
    _close(gt.t, gj.t)


@pytest.mark.parametrize("world", ["grid", "wide"])
def test_torch_scenario_builders(world):
    kw = dict(capacity=48, n_points=96, image_size=(320, 240), bg_cell=32,
              max_deviation=0.8, world=world)
    sj = jdr.build_imageseq_scenario(dtype=jnp.float64, **kw)
    st = tdr.build_imageseq_scenario(dtype=torch.float64, **kw, device="cpu")
    for f in sj._fields:
        _close(getattr(st, f), getattr(sj, f))
    oj = jdr.build_oscillating_scenario(capacity=80, dtype=jnp.float64)
    ot = tdr.build_oscillating_scenario(capacity=80, dtype=torch.float64, device="cpu")
    for f in oj._fields:
        _close(getattr(ot, f), getattr(oj, f))
