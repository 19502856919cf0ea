"""The port's spans on the card: on the profiler's clock (each span's start
against its own ``record_function`` event in the same trace, after a
warm-up frame), and its "host_read" spans one for one with the syncs that
``torch.cuda.set_sync_debug_mode`` flags: as many as the syncs of one frame
of the host-driven tracker (``s03_hostloop``'s loop body), none in a frame
of the scan runner. Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -s \
        tests/test_torch_profiling_cuda.py -m cuda -q

Without a CUDA device every case skips."""

import os
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from surikatoko_tpu_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from benchmark.lib.trace import events_of  # noqa: E402

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from surikatoko_tpu_torch import config
    config.set_full_precision()
    return torch.device("cuda", 0)


def _scan_step(dev):
    from surikatoko_tpu_torch.world.device_runner import make_scan_runner
    params, sc, state, noise, _ = chip_smoke.scenario03_setup(dev,
                                                              torch.float32)
    run = make_scan_runner(params, 1)
    box = [state]

    def step(f):
        box[0] = run(box[0], sc, [f], noise[f - 1:f])[0]
    return step


def _host_step(dev):
    """One frame of the host-driven tracker as the s03_hostloop cell runs
    it: match, recruit, process_frame, the matcher's bookkeeping."""
    from surikatoko_tpu_torch.geom.se3 import SE3
    from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
    from surikatoko_tpu_torch.world.demo_matcher import DemoCornersMatcher
    from surikatoko_tpu_torch.world.runner import init_tracker_state_from_gt
    K = chip_smoke.SC03_K
    params, sc = chip_smoke.oscillating_world(dev, torch.float32, K)
    tracker = MonoSlamFilter(params, capacity=K, update_impl=1)
    gt = SE3(sc.gt_cfw_R, sc.gt_cfw_t)
    m = DemoCornersMatcher(tracker, gt, sc.gt_points, detection_noise_std=0.5,
                           max_new_per_frame=16, max_new_in_first_frame=K,
                           seed=3)
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
    return step


def _syncs_and_reads(step, f):
    """(syncs flagged by the sync debug mode, host_read spans) of frame f
    under a profiler session."""
    with profile(activities=ACTIVITIES):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                step(f)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    reads = [s for s in profiling.window() if s.name == "host_read"]
    return syncs, reads


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["scan", "hostloop"])
def test_torch_spans_on_the_profiler_clock(loop):
    dev = _card()
    step = (_scan_step if loop == "scan" else _host_step)(dev)
    for f in range(0, 3):
        step(f + 1)
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as prof:
        for f in range(4, 25):
            step(f)
        torch.cuda.synchronize()
    spans = profiling.window()
    first = next(s for s in spans if s.name == "frame")
    host = [e for e in events_of(prof) if e[1] == "host"]
    diffs = []
    for name in sorted({s.name for s in spans}):
        mine = sorted(s.start_ns for s in spans if s.name == name)
        theirs = sorted(e[2] for e in host if e[0] == name)
        assert len(mine) == len(theirs), name
        diffs += [abs(a - b) for a, b in zip(mine, theirs)
                  if a > first.end_ns]             # after the first frame
    med, p95 = np.percentile(diffs, [50, 95])
    print(f"clock {loop}: {len(diffs)} spans, |start - event start| median "
          f"{med / 1e3:.2f} us, p95 {p95 / 1e3:.2f} us, max "
          f"{max(diffs) / 1e3:.2f} us")
    assert med <= 10_000 and p95 <= 50_000


@pytest.mark.cuda
def test_torch_host_reads_are_the_syncs_of_a_hostloop_frame():
    step = _host_step(_card())
    for f in range(3):
        step(f)
    torch.cuda.synchronize()
    syncs, reads = _syncs_and_reads(step, 3)
    print(f"hostloop frame: {len(syncs)} syncs flagged, {len(reads)} "
          f"host_read spans; syncs at", sorted(
              f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs))
    assert len(reads) == len(syncs) > 0


@pytest.mark.cuda
def test_torch_a_scan_runner_frame_has_no_host_read():
    step = _scan_step(_card())
    step(1)
    torch.cuda.synchronize()
    syncs, reads = _syncs_and_reads(step, 2)
    assert (len(syncs), len(reads)) == (0, 0)
