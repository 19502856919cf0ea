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
from surikatoko_tpu_torch.geom import camera
from surikatoko_tpu_torch.io import dino
from surikatoko_tpu_torch.models.ba import derivs
from surikatoko_tpu_torch.models.monoslam import state
from surikatoko_tpu_torch.world import ba_scene, device_runner

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
