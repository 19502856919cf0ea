"""The SfM pass cell on the CPU at a tiny size (600 points, 40 keyframes
and a 6-keyframe revisit, a 10-keyframe window, a global BA every 10), its
traced steps covering a whole pass and its closure: a sound run comes out
correct with the pass's metrics and the host-sync metrics read; a run with
one fault planted in the program comes out not correct, caught by the
number that watches it: an adjustment that returns its input (the BA's
cost), a localized pose turned by 1e-2 rad (the pose), a triangulation
that drops the keyframe's new points (the bookkeeping), a closure fed
shuffled pairs (the share of wrong pairs), a Sim(3) pose graph that returns
its input (the closure's poses). And the pass's three readers give None on
a program without the pass's spans."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib.trace import Trace  # noqa: E402

METRICS = ("mvf.integrate_ms_per_frame", "ba.ms_per_frame", "ba.ms_per_trial")
SYNC_METRICS = ("frame.host_syncs_per_frame", "frame.sync_wait_ms_per_frame")


def _edit(spec):
    spec["cfg"]["world"].update(points=600, frames=40, revisit_frames=6)
    spec["cfg"]["pipeline"].update(window=10, global_ba_every=10,
                                   point_bucket=64, frame_bucket=10)
    # a pass is 41 steps: 2 bootstrap keyframes, 38 keyframes, the closure
    spec["traffic"].update(warmup_frames=5, check_frames=3, trace_after=1,
                           trace_steps=45)


def _run(patch=None, seed=2718281829):
    torch.set_num_threads(4)
    return run.run_cell("mvf10k_pass", seed, 0.5, True, device="cpu",
                        edit=_edit, patch=patch)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 46
    assert {"pose_err", "point_err", "ba_cost_rel", "ba_param_err",
            "bookkeeping_mismatch", "closure_wrong_share",
            "closure_pose_err"} <= set(out["compared"])
    for m in METRICS + SYNC_METRICS:
        v = out["metrics"][m]["value"]
        assert isinstance(v, float) and v > 0, m


def _ba_returns_input(mp):
    from surikatoko_tpu_torch.models.ba.lm import SparseBundleAdjustment
    mp.setattr(SparseBundleAdjustment, "compute",
               lambda self, p, term=None: (True, p))
    mp.setattr(SparseBundleAdjustment, "compute_inplace",
               lambda self, p, term=None: (True, p))


def _pose_turned(mp):
    from surikatoko_tpu_torch.models.mvf.factorizer import MultiViewFactorizer
    inner = MultiViewFactorizer.integrate_new_frame_corners
    c, s = np.cos(1e-2), np.sin(1e-2)
    turn = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    def turned(self):
        ok = inner(self)
        if ok:
            self.cam_cfw_R[-1] = turn @ self.cam_cfw_R[-1]
        return ok
    mp.setattr(MultiViewFactorizer, "integrate_new_frame_corners", turned)


def _new_points_dropped(mp):
    from surikatoko_tpu_torch.models.mvf.factorizer import MultiViewFactorizer
    mp.setattr(MultiViewFactorizer, "_store_triangulations",
               lambda self, tri: None)


def _pairs_shuffled(mp):
    from surikatoko_tpu_torch.vision import place_recognition as pr
    inner = pr.verify_loop_pairs

    def shuffled(*a, **kw):
        pairs = inner(*a, **kw)
        heads = [b for _, b in pairs]
        return [(a_, heads[(i + 1) % len(heads)])
                for i, (a_, _) in enumerate(pairs)]
    mp.setattr(pr, "verify_loop_pairs", shuffled)


def _pose_graph_returns_input(mp):
    from surikatoko_tpu_torch.models import posegraph
    mp.setattr(posegraph, "optimize_sim3_graph", lambda g, **kw: g)


@pytest.mark.parametrize("fault,reading", [
    (_ba_returns_input, "ba_cost_rel"),
    (_pose_turned, "pose_err"),
    (_new_points_dropped, "bookkeeping_mismatch"),
    (_pairs_shuffled, "closure_wrong_share"),
    (_pose_graph_returns_input, "closure_pose_err"),
])
def test_planted_fault_is_caught(fault, reading, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"]
    c = out["compared"][reading]
    assert c["value"] > c["limit"], out["compared"]


def _record(steps=3):
    return dict(seconds=1.0, frames=steps, steps=steps, latencies=[0.1] * steps,
                steady=[], setup_s=1.0, work={}, spans={},
                trace=Trace([], [], 1.0, 0.5, [], [], steps))


@pytest.mark.parametrize("name", METRICS)
def test_readers_give_none_without_the_pass_spans(name, monkeypatch):
    from surikatoko_tpu_torch.utils import profiling
    read = run.reader(name)
    S = profiling.Span
    other = [S("frame", -1, 0, 1000), S("host_read", 0, 10, 20)]
    monkeypatch.setattr(profiling, "window", lambda: other)
    assert read(_record()) is None
    monkeypatch.setattr(profiling, "window", lambda: [])
    assert read(_record()) is None
    monkeypatch.delattr(profiling, "window")
    assert read(_record()) is None
    rec = _record()
    rec["trace"] = None
    assert read(rec) is None
