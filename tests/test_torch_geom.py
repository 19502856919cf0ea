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


# the edge angles of tests/test_quat.py::test_rotmat_roundtrip_edge_angles
# and tests/test_so3_se3.py::test_exp_log_roundtrip
EDGE_ANGLES = sorted({0.0, 1e-9, 1e-8, 0.1, 0.3, np.pi / 2, np.pi - 1e-6,
                      np.pi - 1e-7, np.pi})


@pytest.mark.parametrize("angle", EDGE_ANGLES)
def test_torch_quat_so3_edge_angles(angle):
    """to_axis_angle, from_rotmat and log on both sides of their branches,
    from the same rotation (JAX's so3.exp of the same vector)."""
    from surikatoko_tpu.geom import so3 as jso3
    from surikatoko_tpu_torch.geom import so3 as tso3
    axis = np.array([1.0, 2.0, -0.5])
    w_j, w_t = _pair(axis / np.linalg.norm(axis) * angle)
    R_j = jso3.exp(w_j)
    R_t = torch.as_tensor(np.asarray(R_j))
    _close(tso3.exp(w_t), R_j)
    q_j = jquat.from_rotmat(R_j)
    q_t = tquat.from_rotmat(R_t)
    _close(q_t, q_j)
    _close(tquat.to_axis_angle(q_t), jquat.to_axis_angle(q_j))
    _close(tso3.log(R_t), jso3.log(R_j))
    # the quaternion's sign flip branch of to_axis_angle
    _close(tquat.to_axis_angle(-q_t), jquat.to_axis_angle(-q_j))


def test_torch_quat_more(rng):
    q_j, q_t = _pair(rng.normal(size=(12, 4)))
    v_j, v_t = _pair(rng.normal(size=(12, 3)))
    _close(tquat.conj(q_t), jquat.conj(q_j))
    _close(tquat.inv(q_t), jquat.inv(q_j))
    _close(tquat.normalize(q_t), jquat.normalize(q_j))
    u_j, u_t = jquat.normalize(q_j), tquat.normalize(q_t)
    _close(tquat.rotate(u_t, v_t), jquat.rotate(u_j, v_j))
    # small rotations take to_axis_angle's Taylor branch
    s_j, s_t = _pair(np.concatenate([np.ones((6, 1)), 1e-8 * rng.normal(size=(6, 3))],
                                    axis=1))
    _close(tquat.to_axis_angle(s_t), jquat.to_axis_angle(s_j))
    R_j = jquat.to_rotmat(u_j)
    _close(tquat.from_rotmat(torch.as_tensor(np.asarray(R_j))),
           jquat.from_rotmat(R_j))


def test_torch_so3_orthonormalize(rng):
    from surikatoko_tpu.geom import so3 as jso3
    from surikatoko_tpu_torch.geom import so3 as tso3
    M = rng.normal(size=(5, 3, 3))
    M[0] = np.diag([1.0, 1.0, -1.0])        # the det flip
    m_j, m_t = _pair(M)
    _close(tso3.orthonormalize(m_t), jso3.orthonormalize(m_j), rtol=1e-10,
           atol=1e-12)
    _close(tso3.project_onto_so3(m_t), jso3.project_onto_so3(m_j), rtol=1e-10,
           atol=1e-12)


def test_torch_se3_ops(rng):
    from surikatoko_tpu.geom import so3 as jso3
    Ra, Rb = (np.asarray(jso3.exp(jnp.asarray(rng.normal(size=(4, 3)))))
              for _ in range(2))
    ta, tb = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    a_j, b_j = jse3.SE3(*_pair(Ra)[:1], _pair(ta)[0]), jse3.SE3(_pair(Rb)[0],
                                                                 _pair(tb)[0])
    a_t, b_t = tse3.SE3(_pair(Ra)[1], _pair(ta)[1]), tse3.SE3(_pair(Rb)[1],
                                                              _pair(tb)[1])
    x_j, x_t = _pair(rng.normal(size=(4, 3)))
    _close(a_t.apply(x_t), a_j.apply(x_j))
    for got, want in ((a_t.compose(b_t), a_j.compose(b_j)),
                      (tse3.a_from_b(a_t, b_t), jse3.a_from_b(a_j, b_j))):
        _close(got.R, want.R)
        _close(got.t, want.t)
    _close(a_t.matrix4(), a_j.matrix4())
    idj = jse3.identity(jnp.float64, (2,))
    idt = tse3.identity(torch.float64, (2,), device="cpu")
    _close(idt.R, idj.R)
    _close(idt.t, idj.t)
    assert tcam.no_distortion(device="cpu").k1.dtype == torch.float64
    nd = jcam.no_distortion(jnp.float64)
    _close(tcam.no_distortion(torch.float64, device="cpu").k2, nd.k2)


@pytest.mark.parametrize("outliers", [0, 5])
def test_torch_umeyama_robust(rng, outliers):
    """LMedS + MAD refits: the two packages sample other triples (numpy
    here, a JAX key there), so the gates may differ on a point at the
    noise's edge: the outliers are out of both inlier sets, the sets agree
    on all but two points, and (s, R, t) agree to the noise's scale (1e-3
    on points of scale 1), not to rounding."""
    src = rng.normal(size=(45, 3))
    Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    Q = Q * np.sign(np.linalg.det(Q))
    dst = 1.3 * src @ Q.T + np.array([0.2, -0.1, 0.4])
    dst = dst + 1e-3 * rng.normal(size=dst.shape)
    dst[:outliers] += rng.normal(scale=3.0, size=(outliers, 3))
    (s_j, d_j), (s_t, d_t) = zip(_pair(src), _pair(dst))
    got = talign.umeyama_similarity_robust(s_t, d_t)
    want = jalign.umeyama_similarity_robust(s_j, d_j)
    inl_t, inl_j = got[3].numpy(), np.asarray(want[3])
    assert not inl_t[:outliers].any() and not inl_j[:outliers].any()
    assert int(inl_t.sum()) > 30 and int((inl_t != inl_j).sum()) <= 2
    for a, b in zip(got[:3], want[:3]):
        _close(a, b, rtol=1e-3, atol=1e-3)


def test_torch_scene_gen_paths():
    wb = jscene.WorldBounds(-1.5, 1.5, -1.5, -0.4, 0.0, 0.0001)
    for got, want in (
            (tscene.rectangular_path(tscene.WorldBounds(*wb), 10, 6, (3, -2, 7),
                                     (0, 0, 0), (0, 0, 1)),
             jscene.rectangular_path(wb, 10, 6, (3, -2, 7), (0, 0, 0), (0, 0, 1))),
            (tscene.rotate_left_and_right((0.1, 0.2, 0.3), (0, 0, 1), -0.4, 0.7,
                                          2, 12),
             jscene.rotate_left_and_right((0.1, 0.2, 0.3), (0, 0, 1), -0.4, 0.7,
                                          2, 12)),
            (tscene.look_at_path([((0, -2, 0.5), (0, 0, 0), (0, 0, 1)),
                                  ((1, -2, 0.6), (0, 0.1, 0), (0, 0, 1))], 2),
             jscene.look_at_path([((0, -2, 0.5), (0, 0, 0), (0, 0, 1)),
                                  ((1, -2, 0.6), (0, 0.1, 0), (0, 0, 1))], 2))):
        _close(got.R, want.R)
        _close(got.t, want.t)
    cj = jscene.oscillate_right_and_left((0.4, -2.0, 0.5), (0.4, 0.0, 0.5),
                                         (0, 0, 1), 0.6, 2, 160)
    ct = tscene.oscillate_right_and_left((0.4, -2.0, 0.5), (0.4, 0.0, 0.5),
                                         (0, 0, 1), 0.6, 2, 160)
    for k in (0, 17):
        vj, wj = jscene.initial_camera_motion(
            jse3.SE3(cj.R[k], cj.t[k]), jse3.SE3(cj.R[k + 1], cj.t[k + 1]), 1.0)
        vt, wt = tscene.initial_camera_motion(
            tse3.SE3(ct.R[k], ct.t[k]), tse3.SE3(ct.R[k + 1], ct.t[k + 1]), 1.0)
        _close(vt, vj)
        _close(wt, wj, rtol=1e-10, atol=1e-12)
