"""Config reader, views and the MonoSlam demo of the port against the JAX
package: test_io.py's config cases, test_viz_misc.py's view cases,
test_live_view.py's headless viewer, and the demo's main path
(``demos.davison_mono_slam.run``) on configs/scenario01.json for 20 frames
against the JAX demo's run on the same config, frame by frame through the
tracker-internals JSON each writes."""

import json
import os
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from surikatoko_tpu.io.config_reader import ConfigReader as JConfig  # noqa: E402
from surikatoko_tpu_torch.demos import davison_mono_slam as demo  # noqa: E402
from surikatoko_tpu_torch.geom import camera, so3  # noqa: E402
from surikatoko_tpu_torch.geom.ellipse import (  # noqa: E402
    RotatedEllipse2D, ellipsoid_from_covariance)
from surikatoko_tpu_torch.geom.se3 import SE3  # noqa: E402
from surikatoko_tpu_torch.io.config_reader import ConfigReader  # noqa: E402
from surikatoko_tpu_torch.models.monoslam import (  # noqa: E402
    init_state, landmarks, make_params)
from surikatoko_tpu_torch.viz import draw2d, gl_helpers, scene_view  # noqa: E402
from surikatoko_tpu_torch.viz.live_view import LiveMonoSlamView  # noqa: E402
from surikatoko_tpu_torch.world import test_data_builder as tdb  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "scenario01.json")


@pytest.mark.parametrize("path_cfg", [False, True])
def test_torch_config_reader_matches_jax(tmp_path, path_cfg):
    """test_io.py's typed access, coercions, comments, unused keys and the
    -DEV override, on both readers."""
    (tmp_path / "c.json").write_text(json.dumps({
        "// a comment": 0, "f_from_int": 2, "b_from_int": 1, "i_plain": 7,
        "s": "hello", "seq": [1, 2, 3.5], "x": 2.5, "b": 3, "unused": 1}))
    (tmp_path / "c-DEV.json").write_text(json.dumps({"i_plain": 99}))
    src = CONFIG if path_cfg else tmp_path / "c.json"
    t, j = ConfigReader(src), JConfig(src)
    for key in sorted(j._data):
        for typ in (float, int, bool, str):
            try:
                want = j.get_value(key, typ)
            except TypeError:
                with pytest.raises(TypeError):
                    t.get_value(key, typ)
                continue
            assert t.get_value(key, typ) == want
        if isinstance(j._data[key], list):
            assert t.get_seq(key, float) == j.get_seq(key, float)
    assert t.get_value("missing", float, 9.5) == 9.5
    assert not t.has_key("// a comment")
    assert sorted(t.unused_params()) == sorted(j.unused_params())
    if not path_cfg:
        assert t.get_value("i_plain", int) == 99       # the -DEV override


def test_torch_views_match_test_viz_misc(tmp_path):
    """test_viz_misc.py: the GL matrix round trip, the 2D overlays with
    clipping, and the 3D scene PNG."""
    rng = np.random.default_rng(3)
    R = so3.exp(torch.as_tensor(rng.normal(size=3)))
    t = torch.as_tensor(rng.normal(size=3))
    m = gl_helpers.se3_to_gl_mat44(SE3(R, t)).reshape(4, 4).T
    np.testing.assert_allclose(m[:3, :3], R.numpy(), atol=1e-12)
    np.testing.assert_allclose(m[:3, 3], t.numpy(), atol=1e-12)
    eye = gl_helpers.gl_from_hz_camera(SE3(R, t)).reshape(4, 4).T
    np.testing.assert_allclose(eye[:3, :3], np.diag([1, -1, -1]) @ R.numpy())

    img = draw2d.gray_to_rgb(np.zeros((60, 80), np.uint8))
    draw2d.draw_cross(img, (40, 30))
    assert (img[30, 40] == (0, 255, 0)).all()
    e = RotatedEllipse2D(center=torch.tensor([40.0, 30.0]), R=torch.eye(2),
                         semi_axes=torch.tensor([10.0, 5.0]))
    draw2d.draw_ellipse(img, e)
    assert (img[30, 50] == (255, 128, 0)).all()
    draw2d.draw_cross(img, (1000, -50))              # clipped silently
    draw2d.draw_projected_axes(
        img, lambda p: np.array([40 + 10 * p[0], 30 + 10 * p[1], 1.0]))
    assert (img[30, 45] == (255, 0, 0)).all()

    ds = tdb.circus_grid_dataset(n_frames=8, device="cpu")
    cov = torch.diag(torch.tensor([0.01, 0.02, 0.005], dtype=torch.float64))
    ell = ellipsoid_from_covariance(cov, torch.tensor([0.0, 0.0, 0.3],
                                                      dtype=torch.float64))
    out = scene_view.draw_scene(cam_cfw=ds.cfw, points=ds.points,
                                ellipsoids=[ell], gt_cam_cfw=ds.cfw,
                                out_path=str(tmp_path / "scene.png"))
    assert os.path.getsize(out) > 10_000


class _Key:
    def __init__(self, key):
        self.key = key


class _PickEvent:
    def __init__(self, artist, ind):
        self.artist = artist
        self.ind = ind


def _state(params, K=6):
    st = init_state(K, device="cpu")
    rng = np.random.default_rng(0)
    pix = torch.as_tensor(rng.uniform((40, 40), (280, 200), size=(K, 2)))
    rho = torch.as_tensor(rng.uniform(0.4, 0.9, size=K))
    st, _ = landmarks.add_landmarks(params, st, pix, torch.ones(K, dtype=torch.bool),
                                    rho)
    return st


def test_torch_live_view_matches_test_live_view(tmp_path, capsys):
    """test_live_view.py: the headless frame dump, the hotkey state machine
    and scene picking; and the port's rings are finite (the JAX view's are
    NaN, ROADMAP C)."""
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), device="cpu")
    params = make_params(cam, None, dt=1.0, device="cpu")
    st = _state(params)
    view = LiveMonoSlamView(save_frames_dir=str(tmp_path / "frames"))
    for f in range(2):
        view.update(params, st, f, gt_wfc_t=np.zeros(3),
                    obs=torch.zeros(6, 2), obs_mask=torch.ones(6, dtype=torch.bool))
    files = sorted(os.listdir(tmp_path / "frames"))
    assert files == ["frame00000.png", "frame00001.png"]
    assert os.path.getsize(tmp_path / "frames" / files[0]) > 5000
    rings = [ln.get_xydata() for ln in view.ax2d.lines if len(ln.get_xydata()) == 24]
    assert len(rings) == 6 and all(np.isfinite(r).all() for r in rings)
    assert len(view.ax3d.collections) > 1       # scatter + ellipsoid wires

    assert not (view.suppress or view.want_reset or view.want_dump
                or view.want_quit)
    view._on_key(_Key("s"))
    assert view.suppress
    view._on_key(_Key("s"))
    for k in ("u", "i", "q"):
        view._on_key(_Key(k))
    assert not view.suppress
    assert view.want_reset and view.want_dump and view.want_quit

    assert view._pick_map.shape[0] == 6
    view._on_pick(_PickEvent(view._sc_artist, np.asarray([2])))
    assert view.picked_slot == int(view._pick_map[2])
    out = capsys.readouterr().out
    assert f"picked lm[{view.picked_slot}]" in out and "sigma=" in out
    info = view._pick_info[view.picked_slot]
    assert info["sigma"] > 0 and info["gen"] == 1
    view.update(params, st, 2, gt_wfc_t=np.zeros(3))
    assert view.picked_slot is not None
    view._on_key(_Key("escape"))
    assert view.picked_slot is None
    view.close()


def _jax_demo(tmp_path, monkeypatch, *flags):
    """The JAX demo's main with ``flags`` (its own argv), its internals
    JSON read back."""
    sys.path.insert(0, os.path.join(REPO, "demos"))
    import demo_davison_mono_slam as jdemo
    out = str(tmp_path / "jax_internals.json")
    monkeypatch.setattr(sys, "argv", ["demo", *flags, "--out_internals", out])
    assert jdemo.main() == 0
    with open(out) as f:
        return json.load(f)


def test_torch_mono_slam_demo_matches_jax(tmp_path, monkeypatch, capsys):
    """The demo's main path for 20 frames of configs/scenario01.json (the
    distorted camera, the rectangular path): the port's run on the CPU in
    float64 against the JAX demo's, frame by frame, with a checkpoint
    written after frame 11 and a second run resumed from it reaching the
    same end."""
    flags = ["--scene_config", CONFIG, "--frames", "20"]
    jrun = _jax_demo(tmp_path, monkeypatch, *flags)
    ckpt = str(tmp_path / "ckpt.npz")
    out = str(tmp_path / "internals.json")
    m = demo.run(demo.make_args(scene_config=CONFIG, frames=20, device="cpu",
                                out_internals=out, checkpoint_every=12,
                                checkpoint_path=ckpt), log=lambda *a: None)
    with open(out) as f:
        trun = json.load(f)
    assert m["frames"] == jrun["FramesCount"] == 20 and m["finite"]
    for fj, ft in zip(jrun["Frames"], trun["Frames"], strict=True):
        for key in ("EstimatedSalPnts", "NewSalPnts", "CommonSalPnts",
                    "DeletedSalPnts"):
            assert ft[key] == fj[key], key
        np.testing.assert_allclose(ft["CamState"], fj["CamState"], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(ft["CamStateGT"], fj["CamStateGT"],
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(m["ate_rmse"], jrun["AteRmse"], rtol=1e-9)
    assert m["unused_params"] == ["scene_source"]
    # resume from the checkpoint: frames 12-19 again, the same end
    m2 = demo.run(demo.make_args(scene_config=CONFIG, frames=20, device="cpu",
                                 out_internals="", resume=True,
                                 checkpoint_path=ckpt), log=lambda *a: None)
    assert m2["frames"] == 8
    np.testing.assert_allclose(m2["cam_states"][-1], m["cam_states"][-1],
                               rtol=0, atol=1e-12)


def test_torch_mono_slam_demo_views_and_flags(tmp_path):
    """--save_view_frames dumps one PNG a frame; the fault-injection and
    recovery flags run (suppression, reset to GT, a state dump)."""
    lines = []
    m = demo.run(demo.make_args(
        scene_config=CONFIG, frames=6, device="cpu", out_internals="",
        save_view_frames=str(tmp_path / "v"), suppress_observations_from=2,
        suppress_observations_to=3, reset_to_gt_at=4, dump_state_at=5,
        x64=False), log=lines.append)
    assert m["dtype"] == "float64"        # the CPU's default type
    assert len(os.listdir(tmp_path / "v")) == 6
    assert m["obs_counts"][2] == 0 and m["finite"]
    assert any("reset to ground truth" in ln for ln in lines)
    assert any("frame_ind=" in ln for ln in lines)
    with pytest.raises(TypeError):
        demo.make_args(no_such_flag=1)


def test_torch_distribution_views_and_demo_never_import_jax():
    """The modules of the distribution layer, the views, the config reader,
    the MonoSlam demo and chip_smoke.py import neither JAX nor the JAX
    package (matplotlib only inside the views' functions)."""
    import subprocess
    mods = ["surikatoko_tpu_torch.parallel", "surikatoko_tpu_torch.parallel.launch",
            "surikatoko_tpu_torch.parallel.multihost",
            "surikatoko_tpu_torch.parallel.sharded_ekf",
            "surikatoko_tpu_torch.parallel.sharded_schur",
            "surikatoko_tpu_torch.parallel.sharded_imageseq",
            "surikatoko_tpu_torch.parallel.dryrun",
            "surikatoko_tpu_torch.parallel.parity",
            "surikatoko_tpu_torch.io.config_reader", "surikatoko_tpu_torch.viz",
            "surikatoko_tpu_torch.viz.live_view",
            "surikatoko_tpu_torch.demos.davison_mono_slam", "chip_smoke"]
    code = ("import sys, importlib; [importlib.import_module(m) for m in "
            f"{mods!r}]; bad = sorted(m for m in sys.modules if m in "
            "('jax', 'surikatoko_tpu', 'matplotlib') or m.startswith(("
            "'jax.', 'surikatoko_tpu.'))); print(bad); sys.exit(1 if bad else 0)")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": os.path.abspath(REPO)}
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
