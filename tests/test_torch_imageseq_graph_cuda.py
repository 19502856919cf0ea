"""The image loop's CUDA graph on the card: one-frame calls of
``make_imageseq_scan_runner(recruit=True)``, replayed as one graph a frame
(render, the search kernel B1, deletion, the detector, the fused recruit
congruence with B2, the predict), against the eager multi-frame loop over
the same frames, bit for bit: state, templates and every output. In the
benchmark's ``k768_churn`` regime (its configuration and world, float32,
frames from a state warmed eagerly over frames 1-120): 40 calls at K = 64,
where slots are deleted and recruited, and 4 at K = 768. Every call under
``torch.cuda.set_sync_debug_mode("error")``; the caller's state and
templates untouched by a call, a returned state by the next; one capture
for a runner's key, at its first call, and one more for a second scenario
object. Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_imageseq_graph_cuda.py -m cuda -q

Without a CUDA device every case skips."""

import contextlib
import json
import os
import sys

import pytest
import torch

from surikatoko_tpu_torch.models.monoslam import init_state
from surikatoko_tpu_torch.utils.profiling import counts
from surikatoko_tpu_torch.world import device_runner as dr

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from benchmark.lib import program, wide_world  # noqa: E402

COUNTERS = ("frame.graph_captures", "frame.graph_replays")
SEED = 3141592653
WARM = range(1, 121)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only on a card")
    from surikatoko_tpu_torch import config
    config.set_full_precision()
    return torch.device("cuda", 0)


def _cell(capacity: int):
    """(runner, scenario, state, templates) of the ``k768_churn`` cell's
    configuration at ``capacity`` slots, warmed eagerly over frames
    1-120."""
    dev = _card()
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "monoslam_wide_k768.json")) as f:
        cfg = json.load(f)
    dtype, rc = program.dtype_of(cfg), cfg["runner"]
    world = wide_world.build(cfg, SEED)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    sc = dr.ImageSeqDeviceScenario(
        gt_cfw_R=t(world.gt_cfw_R), gt_cfw_t=t(world.gt_cfw_t),
        gt_points=t(world.points), background=t(world.background),
        splat_amp=t(world.splat_amp), splat_sigma=t(world.splat_sigma))
    params = program.params(cfg, dtype, dev)
    run = dr.make_imageseq_scan_runner(
        params, templ_width=rc["templ_width"],
        search_radius=rc["search_radius"], min_corr_coeff=rc["min_corr_coeff"],
        chi2_gate=rc["chi2_gate"], subpixel=rc["subpixel"], recruit=True,
        recruit_max=rc["recruit_max"], detector_corners=rc["detector_corners"],
        detector_quality=rc["detector_quality"],
        detector_nms_radius=rc["detector_nms_radius"],
        recruit_min_dist=rc["recruit_min_dist"],
        recruit_depth=rc["recruit_depth"])
    st, tm = dr.init_imageseq(params, sc, init_state(capacity, dtype=dtype,
                                                     device=dev),
                              rc["templ_width"])
    st, tm, _ = run(st, tm, sc, WARM)
    return run, sc, st, tm


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


def _chain(run, st, tm, sc, frames):
    """One call a frame, each checked to leave its state and templates as
    they were; returns (state, templates, each output concatenated over the
    frames)."""
    outs = []
    for f in frames:
        kept = [t.clone() for t in (*st, tm)]
        with _no_sync():
            got = run(st, tm, sc, [f])
        for name, a, b in zip((*dr.MonoSlamState._fields, "templates"),
                              (*st, tm), kept):
            assert torch.equal(a, b), (f, name)
        st, tm, out = got
        outs.append(out)
    return st, tm, [torch.cat([o[i] for o in outs])
                    for i in range(len(outs[0]))]


def _assert_equal(got, want):
    st, tm, outs = got
    for name, a, b in zip(dr.MonoSlamState._fields, st, want[0]):
        assert torch.equal(a, b), name
    assert torch.equal(tm, want[1])
    for i, (a, b) in enumerate(zip(outs, want[2])):
        assert torch.equal(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,calls", [(64, 40), (768, 4)])
def test_torch_imageseq_graph_equals_the_eager_loop(capacity, calls):
    """The first call warms up, captures and replays, the rest replay: one
    capture and as many replays as calls, the same bits as one eager
    multi-frame call; at K = 64 slots are deleted and recruited on the
    way."""
    run, sc, st, tm = _cell(capacity)
    frames = range(WARM[-1] + 1, WARM[-1] + 1 + calls)
    want = run(st, tm, sc, frames)
    c0 = _counts()
    got = _chain(run, st, tm, sc, frames)
    assert [b - a for a, b in zip(c0, _counts())] == [1, calls]
    _assert_equal(got, want)
    assert int(got[2][5].max()) == 0                   # chol_info
    if capacity == 64:
        assert int(got[2][3].sum()) > 0                # n_recruited
        assert bool((got[0].lm_generation > st.lm_generation).any())


@pytest.mark.cuda
def test_torch_imageseq_graph_returns_fresh_tensors():
    """What a replay returns is the caller's: the next replay leaves it as
    it was, and no returned tensor shares memory with another call's."""
    run, sc, st, tm = _cell(64)
    for f in (121, 122):                   # the capture, then a replay
        st, tm, _ = run(st, tm, sc, [f])
    flat = lambda out: (*out[0], out[1], *out[2])  # noqa: E731
    with _no_sync():
        first = run(st, tm, sc, [123])
        kept = [t.clone() for t in flat(first)]
        second = run(first[0], first[1], sc, [124])
    for a, b in zip(flat(first), kept):
        assert torch.equal(a, b)
    ptrs = lambda out: {t.data_ptr() for t in flat(out)}  # noqa: E731
    assert not ptrs(first) & ptrs(second)
    assert not torch.equal(first[0].x, second[0].x)


@pytest.mark.cuda
def test_torch_imageseq_graph_recaptures_for_another_scenario():
    """A second scenario object with the same values: one more capture, and
    the same bits as the first scenario's graph."""
    run, sc, st, tm = _cell(64)
    sc2 = dr.ImageSeqDeviceScenario(*(t.clone() for t in sc))
    frames = range(121, 125)
    c0 = _counts()
    one = _chain(run, st, tm, sc, frames)
    assert [b - a for a, b in zip(c0, _counts())] == [1, 4]
    two = _chain(run, st, tm, sc2, frames)
    assert [b - a for a, b in zip(c0, _counts())] == [2, 8]
    _assert_equal(two, (one[0], one[1], one[2]))
