"""The port's spans (``utils/profiling.span``) on the CPU: off without a
profiler session (one shared no-op, nothing recorded), and under a session
the spans of one scan-runner frame, one batched (vmapped) frame and one
``process_frame`` with their parents; a new session starts a new record,
and a frame traced and untraced leaves every state tensor bit for bit
equal. Imports no JAX."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.monoslam import init_state
from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
from surikatoko_tpu_torch.utils import profiling
from surikatoko_tpu_torch.world import device_runner as dr
from surikatoko_tpu_torch.world.demo_matcher import DemoCornersMatcher
from surikatoko_tpu_torch.world.runner import init_tracker_state_from_gt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

K = 16
DTYPE = torch.float64

# one frame of each loop: (name, parent's name) in the order they open
SCAN_FRAME = [("frame", None), ("frame.match", "frame"),
              ("frame.update", "frame"), ("frame.predict", "frame"),
              ("b2", "frame.predict")]
HOST_FRAME = [("matcher.match", None)] + [("host_read", "matcher.match")] * 4 \
    + [("matcher.recruit", None)] + [("host_read", "matcher.recruit")] * 5 \
    + [("frame", None), ("frame.update", "frame"), ("b2", "frame.update"),
       ("frame.health", "frame"), ("frame.recruit", "frame"),
       ("frame.predict", "frame")] \
    + [("matcher.book", None), ("host_read", "matcher.book")] * 2


def _session(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.window()


def _named(spans):
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans]


def _scan(batch: int = 0):
    params, sc = chip_smoke.oscillating_world("cpu", DTYPE, K)
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=DTYPE)  # noqa: E731
    state = dr.init_with_gt_landmarks(params, sc, init_state(K, dtype=DTYPE,
                                                             device="cpu"),
                                      t(rng.standard_normal((K, 2))))
    shape = ((batch,) if batch else ()) + (3, K, 2)
    noise = t(rng.standard_normal(shape))
    run = (dr.make_batched_scan_runner(params, 1) if batch
           else dr.make_scan_runner(params, 1))
    return lambda f: run(state, sc, [f], noise[..., f - 1:f, :, :])


def _hostloop():
    """A fresh tracker and matcher on the scenario03 world at K; step(f)
    runs one frame of run_scenario's body and returns the state."""
    params, sc = chip_smoke.oscillating_world("cpu", DTYPE, K)
    tracker = MonoSlamFilter(params, capacity=K, update_impl=1)
    gt = SE3(sc.gt_cfw_R, sc.gt_cfw_t)
    m = DemoCornersMatcher(tracker, gt, sc.gt_points, detection_noise_std=0.5,
                           seed=3, max_new_in_first_frame=K)
    box = [init_tracker_state_from_gt(tracker, gt, dt=float(params.dt))]

    def step(f):
        st = box[0]
        obs, mask = m.match_salient_points(st, f)
        new_pix, new_mask, rho, frags = m.recruit_new_salient_points(st, f,
                                                                     mask)
        st, stats = tracker.process_frame(st, obs, mask, new_pix, new_mask,
                                          rho)
        m.on_landmarks_added(stats.new_slots, frags, st)
        m.sync_removed(st)
        box[0] = st
        return st
    return step


def test_torch_span_is_one_shared_noop_without_a_profiler():
    assert profiling.span("frame") is profiling.span("b2")
    before = profiling.window()
    _scan()(1)
    _hostloop()(0)
    assert profiling.window() == before


def test_torch_spans_of_one_frame_and_their_parents():
    step = _scan()
    _, spans = _session(lambda: step(1))
    assert _named(spans) == SCAN_FRAME
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    step = _scan(batch=3)
    _, spans = _session(lambda: step(1))
    assert _named(spans) == SCAN_FRAME          # one span a batched frame
    step = _hostloop()
    step(0)
    _, spans = _session(lambda: step(1))
    assert _named(spans) == HOST_FRAME


def test_torch_a_new_session_starts_a_new_record():
    step = _scan()
    _, first = _session(lambda: step(1))
    _, second = _session(lambda: (step(1), step(2)))
    assert len(first) == len(SCAN_FRAME)
    assert len(second) == 2 * len(SCAN_FRAME)
    assert second[0].start_ns > first[-1].end_ns
    assert profiling.window() == second


@pytest.mark.parametrize("loop", ["scan", "batch", "hostloop"])
def test_torch_tracing_leaves_the_state_bit_for_bit(loop):
    make = {"scan": _scan, "batch": lambda: _scan(batch=3),
            "hostloop": _hostloop}[loop]
    frames = (1, 2)

    def run(step):
        out = None
        for f in frames:
            out = step(f)
        return out[0] if loop != "hostloop" else out
    plain = run(make())
    step = make()
    traced, spans = _session(lambda: run(step))
    assert spans
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
