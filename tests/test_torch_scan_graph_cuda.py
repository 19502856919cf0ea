"""The GT-matcher scan runners' CUDA graph on the card: one-frame calls,
replayed as one graph a frame, against the eager multi-frame loop over the
same frames and noise, bit for bit (scenario03 at K=96 in float32: 60 calls
of ``make_scan_runner``, 5 of each sequential update impl, 10 of
``make_batched_scan_runner`` with 4 instances); every call under
``torch.cuda.set_sync_debug_mode("error")``; a returned state untouched
by the next call; one capture for a runner's key, at its first call, and
one more for a second scenario object. Imports no JAX, so it runs where the
card is:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_scan_graph_cuda.py -m cuda -q

Without a CUDA device every case skips."""

import contextlib
import os
import sys

import pytest
import torch

from surikatoko_tpu_torch.utils.profiling import counts
from surikatoko_tpu_torch.world import device_runner as dr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

COUNTERS = ("frame.graph_captures", "frame.graph_replays")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only on a card")
    from surikatoko_tpu_torch import config
    config.set_full_precision()
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _no_sync():
    """Any synchronizing CUDA call inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _counts():
    c = counts()
    return [c.get(n, 0) for n in COUNTERS]


def _chain(run, state, sc, frames, noise, batched):
    """One call a frame; returns (state, each output concatenated over the
    frames)."""
    outs = []
    with _no_sync():
        for t, f in enumerate(frames):
            state, *out = run(state, sc, [f], noise[:, t:t + 1] if batched
                              else noise[t:t + 1])
            outs.append(out)
    return state, [torch.cat([o[i] for o in outs], int(batched))
                   for i in range(len(outs[0]))]


def _assert_equal(got, want):
    st, outs = got
    for name, a, b in zip(dr.MonoSlamState._fields, st, want[0]):
        assert torch.equal(a, b), name
    for a, b in zip(outs, want[1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,calls", [(1, 60), (2, 5), (3, 5), (4, 5)])
def test_torch_scan_graph_equals_the_eager_loop(impl, calls):
    """The first call warms up, captures and replays, the rest replay: one
    capture and as many replays as calls."""
    dev = _card()
    params, sc, state, noise, _ = chip_smoke.scenario03_setup(dev,
                                                              torch.float32)
    frames, noise = range(1, calls + 1), noise[:calls]
    want = dr.make_scan_runner(params, impl)(state, sc, frames, noise)
    c0 = _counts()
    got = _chain(dr.make_scan_runner(params, impl), state, sc, frames, noise,
                 False)
    assert [b - a for a, b in zip(c0, _counts())] == [1, calls]
    _assert_equal(got, want)


@pytest.mark.cuda
def test_torch_batched_scan_graph_equals_the_eager_loop():
    """4 instances, 10 calls from a state shared by the instances: the
    first two calls capture (shared, then batched state), every call
    replays; vmap runs inside the capture."""
    dev = _card()
    params, sc, state, ate_noise, _ = chip_smoke.scenario03_setup(
        dev, torch.float32)
    noise = chip_smoke.batch_scan_noise(dev, torch.float32, ate_noise)[:4, :10]
    frames = range(1, 11)
    want = dr.make_batched_scan_runner(params, 1)(state, sc, frames, noise)
    c0 = _counts()
    got = _chain(dr.make_batched_scan_runner(params, 1), state, sc, frames,
                 noise, True)
    assert [b - a for a, b in zip(c0, _counts())] == [2, 10]
    assert got[0].x.shape == (4, state.x.shape[0])
    _assert_equal(got, want)


@pytest.mark.cuda
def test_torch_scan_graph_returns_fresh_tensors():
    """What a replay returns is the caller's: the next replay leaves it as
    it was, and no returned tensor shares memory with another call's."""
    dev = _card()
    params, sc, state, noise, _ = chip_smoke.scenario03_setup(dev,
                                                              torch.float32)
    run = dr.make_scan_runner(params, 1)
    for f in (1, 2):                       # the capture, then a replay
        state = run(state, sc, [f], noise[f - 1:f])[0]
    with _no_sync():
        first = run(state, sc, [3], noise[2:3])
        kept = [t.clone() for t in (*first[0], *first[1:])]
        second = run(first[0], sc, [4], noise[3:4])
    for a, b in zip((*first[0], *first[1:]), kept):
        assert torch.equal(a, b)
    ptrs = lambda out: {t.data_ptr() for t in (*out[0], *out[1:])}
    assert not ptrs(first) & ptrs(second)
    assert not torch.equal(first[0].x, second[0].x)


@pytest.mark.cuda
def test_torch_scan_graph_recaptures_for_another_scenario():
    """A second scenario object with the same values: one more capture, and
    the same bits as the first scenario's graph."""
    dev = _card()
    params, sc, state, noise, _ = chip_smoke.scenario03_setup(dev,
                                                              torch.float32)
    sc2 = dr.DeviceScenario(*(t.clone() for t in sc))
    run = dr.make_scan_runner(params, 1)
    c0 = _counts()
    one = _chain(run, state, sc, range(1, 5), noise[:4], False)
    assert [b - a for a, b in zip(c0, _counts())] == [1, 4]
    two = _chain(run, state, sc2, range(1, 5), noise[:4], False)
    assert [b - a for a, b in zip(c0, _counts())] == [2, 8]
    _assert_equal(two, (one[0], *one[1]))
