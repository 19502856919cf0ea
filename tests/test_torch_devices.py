"""The port's entry points run on the card unless the caller asks for the CPU:
each public function that makes state, scenario or problem tensors defaults
to ``device="cuda"`` and to ``config.default_dtype(device)`` (float32 on the
card, float64 on the CPU). Without a card a default call raises, from torch
itself: nothing picks the CPU because it finds no GPU. Imports no JAX."""

import inspect
import os

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch import interop
from surikatoko_tpu_torch.geom import camera, se3
from surikatoko_tpu_torch.io import dino, frame_loader
from surikatoko_tpu_torch.demos import multi_view_factorization as mvf_demo
from surikatoko_tpu_torch.demos import mvf_at_scale
from surikatoko_tpu_torch.geom import rect
from surikatoko_tpu_torch.models import posegraph
from surikatoko_tpu_torch.models.ba import derivs
from surikatoko_tpu_torch.models.mvf import MultiViewFactorizer, TrackStore
from surikatoko_tpu_torch.models.monoslam import filter as filter_mod
from surikatoko_tpu_torch.models.monoslam import state
from surikatoko_tpu_torch.utils import stats
from surikatoko_tpu_torch.vision import matcher, multiscale
from surikatoko_tpu_torch.vision import place_recognition as pr
from surikatoko_tpu_torch.world import ba_scene, device_runner, test_data_builder

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _cam(device):
    return camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01),
                                  device=device)


def _to_numpy(obj):
    """The same structure with every tensor as a numpy array (what the tests
    make of a JAX object before handing it to ``interop``)."""
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_numpy(x) for x in obj))
    return obj


def _host(fn, *args, **kw):
    return _to_numpy(fn(*args, device="cpu", **kw))


# (function, call with the device keyword given or left out)
ENTRY_POINTS = {
    "make_intrinsics": (camera.make_intrinsics, lambda f, **d: f(
        (320, 240), (160.0, 120.0), 1.95, (0.01, 0.01), **d)),
    "make_params": (state.make_params, lambda f, **d: f(
        _cam(d.get("device", "cuda" if torch.cuda.is_available() else "cpu")),
        **d)),
    "init_state": (state.init_state, lambda f, **d: f(4, **d)),
    "build_oscillating_scenario": (device_runner.build_oscillating_scenario,
                                   lambda f, **d: f(capacity=8, **d)),
    "build_imageseq_scenario": (device_runner.build_imageseq_scenario,
                                lambda f, **d: f(capacity=8, n_points=8,
                                                 image_size=(64, 48), **d)),
    "params_from_numpy": (interop.params_from_numpy, lambda f, **d: f(
        _host(state.make_params, _cam("cpu")), **d)),
    "state_from_numpy": (interop.state_from_numpy, lambda f, **d: f(
        _host(state.init_state, 4), **d)),
    "scenario_from_numpy": (interop.scenario_from_numpy, lambda f, **d: f(
        _host(device_runner.build_oscillating_scenario, capacity=8), **d)),
    "se3_from_numpy": (interop.se3_from_numpy, lambda f, **d: f(
        _to_numpy(se3.identity(batch_shape=(3,), device="cpu")), **d)),
    "no_distortion": (camera.no_distortion, lambda f, **d: f(**d)),
    "se3_identity": (se3.identity, lambda f, **d: f(batch_shape=(2,), **d)),
    "templates_from_numpy": (interop.templates_from_numpy,
                             lambda f, **d: f(np.zeros((2, 5, 5)), **d)),
    "ba_problem_from_numpy": (interop.ba_problem_from_numpy, lambda f, **d: f(
        _to_numpy(dino.synthetic_dino_problem(4, 10, device="cpu")[0]), **d)),
    "sparse_problem_from_numpy": (interop.sparse_problem_from_numpy, lambda f, **d: f(
        _host(ba_scene.build_at_scale_problem, 40, 8, 3)[0], **d)),
    "load_dino_problem": (dino.load_dino_problem,
                          lambda f, **d: f(FIXTURES, f0=600.0, **d)),
    "load_dino_problem_sparse": (dino.load_dino_problem_sparse,
                                 lambda f, **d: f(FIXTURES, f0=600.0, **d)),
    "synthetic_dino_problem": (dino.synthetic_dino_problem,
                               lambda f, **d: f(4, 10, **d)),
    "build_at_scale_problem": (ba_scene.build_at_scale_problem,
                               lambda f, **d: f(40, 8, 3, **d)),
    "frame_var_mask": (derivs.frame_var_mask, lambda f, **d: f(4, **d)),
    "make_pose_graph": (posegraph.make_pose_graph, lambda f, **d: f(
        np.stack([np.eye(3)] * 2), np.zeros((2, 3)),
        [(0, 1, np.eye(3), np.ones(3), 1.0)], **d)),
    "make_sim3_graph": (posegraph.make_sim3_graph, lambda f, **d: f(
        np.stack([np.eye(3)] * 2), np.zeros((2, 3)),
        [(0, 1, np.eye(3), np.ones(3), 1.0, 1.0)], **d)),
    "rect_make": (rect.make, lambda f, **d: f(0, 1, 4, 3, **d)),
    "circle_grid_problem": (ba_scene.circle_grid_problem,
                            lambda f, **d: f(noise_pnt=0.01, **d)),
    "crystall_grid_dataset": (test_data_builder.crystall_grid_dataset,
                              lambda f, **d: f(n_frames=3, **d)),
    "circus_grid_dataset": (test_data_builder.circus_grid_dataset,
                            lambda f, **d: f(n_frames=3, **d)),
    "mean_std_init": (stats.mean_std_init, lambda f, **d: f(**d)),
}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for x in obj:
            yield from _tensors(x)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_torch_entry_point_defaults_to_the_card(name):
    fn, call = ENTRY_POINTS[name]
    params = inspect.signature(fn).parameters
    assert params["device"].default == "cuda"
    if "dtype" in params:
        assert params["dtype"].default is None
    if torch.cuda.is_available():
        out = list(_tensors(call(fn)))
        assert out and all(t.device.type == "cuda" for t in out)
        if "dtype" in params:
            assert all(t.dtype == torch.float32 for t in out if t.is_floating_point())
    else:
        # torch itself refuses: there is no fallback to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            call(fn)
    out = list(_tensors(call(fn, device="cpu")))
    assert out and all(t.device.type == "cpu" for t in out)
    assert all(t.dtype == torch.float64 for t in out if t.is_floating_point())


def test_torch_frame_loader_defaults_to_the_card():
    """FrameLoader's frames are for the card unless the caller asks for the
    CPU: on the card they come in pinned host memory (their upload does not
    block the host); without a card the default raises from torch."""
    fn = frame_loader.FrameLoader
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    frames_dir = os.path.join(FIXTURES, "frames")
    if torch.cuda.is_available():
        with fn(frames_dir) as fl:
            assert fl.native
            assert all(g.is_pinned() and g.device.type == "cpu" for _, g in fl)
    else:
        with pytest.raises(RuntimeError), fn(frames_dir) as fl:
            list(fl)
    with fn(frames_dir, device="cpu") as fl:
        assert all(not g.is_pinned() for _, g in fl)


@pytest.mark.parametrize("cls", [matcher.ImageTemplCornersMatcher,
                                 matcher.KltCornersMatcher])
def test_torch_matchers_take_the_trackers_device(cls):
    """The image matchers have no device argument: they run where the
    tracker's params live, and hand their outputs over there."""
    assert "device" not in inspect.signature(cls.__init__).parameters
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    params = state.make_params(_cam(dev), device=dev)
    tr = filter_mod.MonoSlamFilter(params, capacity=4)
    m = cls(tr, templ_width=9, search_radius=4, detector_max_corners=8)
    assert m.device == tr.device == params.dt.device
    img = np.random.default_rng(0).uniform(0, 255, (60, 80)).astype(np.float32)
    for _ in range(2):
        m.analyze_frame(img)
    st = tr.init_state()
    outs = (*m.match_salient_points(st, 0),
            *m.recruit_new_salient_points(st, 0, None))
    assert all(t.device.type == dev for t in outs)
    assert m._image.device.type == dev and m._image.dtype == torch.float32


def _two_frame_factorizer(**kw):
    """A factorizer holding the two known frames of a 27-point grid seen
    from two cameras, and a third frame's corners."""
    pts = np.stack(np.meshgrid(*[np.linspace(-1, 1, 3)] * 3),
                   -1).reshape(-1, 3)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    m = MultiViewFactorizer(track_store=TrackStore(len(pts), 3), K=K, **kw)
    for f, x in enumerate((0.0, 0.3, 0.6)):
        t = np.array([-x, 0.0, 6.0])
        ph = (pts + t) @ K.T
        for tid, p in enumerate(ph[:, :2] / ph[:, 2:3]):
            m.track_store.add_corner(tid, f, p, np.linalg.inv(K))
        if f < 2:
            m.add_known_frame(se3.SE3(np.eye(3), t))
            for tid, p in enumerate(pts):
                m.set_known_point(tid, p)
    return m


def test_torch_mvf_entry_points_default_to_the_card():
    """The factorizer, its carrier from a JAX factorizer's state and the two
    demo runners do their device work on the card unless the caller asks
    for the CPU, in config.default_dtype(device); without a card the first
    device call raises."""
    for fn in (MultiViewFactorizer, interop.mvf_from_numpy, mvf_demo.run,
               mvf_demo.run_factorizer):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda", fn
        assert params["dtype"].default is None, fn
    args = mvf_at_scale.make_args()
    assert args.device == "cuda" and args.dtype is None
    m = _two_frame_factorizer()
    assert m.device == torch.device("cuda") and m.dtype == torch.float32
    assert interop.mvf_from_numpy(m).device == torch.device("cuda")
    if torch.cuda.is_available():
        assert m.integrate_new_frame_corners()
        assert mvf_demo.run(frames=4)["device"].startswith("cuda")
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            m.integrate_new_frame_corners()
        with pytest.raises((AssertionError, RuntimeError)):
            mvf_demo.run(frames=4)
        with pytest.raises((AssertionError, RuntimeError)):
            mvf_at_scale.run_at_scale(mvf_at_scale.make_args(
                points=60, frames=12, revisit_frames=0))
    m = _two_frame_factorizer(device="cpu")
    assert m.dtype == torch.float64 and m.integrate_new_frame_corners()
    assert m.frames_count() == 3


def test_torch_place_recognition_entry_points_default_to_the_card():
    """describe_tracks, ransac_similarity_pairs and detect_and_describe do
    their device work on the card unless the caller asks for the CPU (the
    RANSAC in config.default_dtype(device)); the at-scale demo closes its
    loop without the GT oracle by default, on the card."""
    for fn in (pr.describe_tracks, pr.ransac_similarity_pairs,
               multiscale.detect_and_describe):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert inspect.signature(pr.ransac_similarity_pairs).parameters[
        "dtype"].default is None
    args = mvf_at_scale.make_args()
    assert (args.device, args.dtype, args.oracle_pairs) == ("cuda", None, False)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (120, 160))
    frames = [(img, rng.uniform(40, 110, (6, 2)), list(range(6)))]
    A = rng.normal(size=(8, 3))
    calls = (lambda **d: pr.describe_tracks(frames, **d).desc,
             lambda **d: multiscale.detect_and_describe(img, levels=2,
                                                        **d).descriptors)
    if torch.cuda.is_available():
        assert all(c().device.type == "cuda" for c in calls)
        assert pr.ransac_similarity_pairs(A, A + 1.0, 0.1).all()
    else:
        for c in calls:
            with pytest.raises((AssertionError, RuntimeError)):
                c()
        with pytest.raises((AssertionError, RuntimeError)):
            pr.ransac_similarity_pairs(A, A + 1.0, 0.1)
    assert all(c(device="cpu").device.type == "cpu" for c in calls)
    assert pr.ransac_similarity_pairs(A, A + 1.0, 0.1, device="cpu").all()


def test_torch_batch_entry_points_default_to_the_card():
    """Batched evaluation: the BA runners' argument sets name the card,
    their problems and the batched LM's results land there, and the batched
    scan runner runs where the scenario and state it is given lie."""
    from surikatoko_tpu_torch.demos import (ba_at_scale, batch_ba,
                                            bundle_adj_circle_grid,
                                            bundle_adj_dinosaur)
    from surikatoko_tpu_torch.models.ba import BundleAdjustment
    for mod in (batch_ba, bundle_adj_circle_grid, bundle_adj_dinosaur,
                ba_at_scale):
        assert mod.make_args().device == "cuda"
    # the dino pin's runner takes its device from the caller: no default
    dev_param = inspect.signature(bundle_adj_dinosaur.dino_ate).parameters["device"]
    assert dev_param.default is inspect.Parameter.empty
    if torch.cuda.is_available():
        probs = batch_ba.problems(batch_ba.make_args(batch=2))
        assert all(t.device.type == "cuda" for p in probs for t in p)
        out = BundleAdjustment().compute_batched(interop.stack(probs)).p
        assert all(t.device.type == "cuda" for t in out)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            batch_ba.problems(batch_ba.make_args(batch=2))
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    params = state.make_params(_cam(dev), device=dev)
    sc = device_runner.build_oscillating_scenario(capacity=8, device=dev)
    st = state.init_state(8, device=dev)
    noise = torch.zeros((2, 2, 8, 2), dtype=sc.gt_points.dtype, device=dev)
    out = device_runner.make_batched_scan_runner(params, 1)(st, sc, [1, 2], noise)
    assert out[0].x.shape[0] == 2 and out[1].shape == (2, 2)
    assert all(t.device.type == dev for t in _tensors(out))


def test_torch_distribution_entry_points_default_to_the_card():
    """The distribution layer: a rank pool, ``multihost.initialize``, the
    dry run and the sharded parity checks name the card (NCCL) unless the
    caller asks for the CPU (gloo), and a pool without a card raises before
    it starts a rank."""
    from surikatoko_tpu_torch.parallel import dryrun, launch, multihost, parity
    for fn in (launch.RankPool.__init__, launch.run_ranks,
               multihost.initialize, dryrun.dryrun_multichip,
               parity.sharded_parity):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.RankPool(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.run_ranks(launch.free_port, 1)
