"""The readers of the program's own spans on a synthetic record: the
host-read count and wait, the update's host self time and its device time,
each with the "b2" child left out, and None without a trace, without the
program's spans, or with a program whose profiling module has no
``window`` (the parent of the change that added it)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib.trace import Trace  # noqa: E402
from surikatoko_tpu_torch.utils import profiling  # noqa: E402

US = 1000
NAMES = ("frame.host_syncs_per_frame", "frame.sync_wait_ms_per_frame",
         "update.host_ms_per_frame", "update.device_ms_per_frame")


def _spans():
    """Two steps. Step 0: a matcher call with two host reads (30 and 50
    us), a frame whose update (100-600 us) holds B2 (400-500 us). Step 1:
    one host read (20 us), a frame whose update (1100-1300 us) has no B2,
    and a B2 outside any update (under the predict)."""
    S = profiling.Span
    return [
        S("matcher.match", -1, 0, 90 * US),
        S("host_read", 0, 10 * US, 40 * US),
        S("host_read", 0, 40 * US, 90 * US),
        S("frame", -1, 95 * US, 900 * US),
        S("frame.update", 3, 100 * US, 600 * US),
        S("b2", 4, 400 * US, 500 * US),
        S("frame.predict", 3, 600 * US, 900 * US),
        S("matcher.match", -1, 1000 * US, 1050 * US),
        S("host_read", 7, 1010 * US, 1030 * US),
        S("frame", -1, 1050 * US, 1500 * US),
        S("frame.update", 9, 1100 * US, 1300 * US),
        S("frame.predict", 9, 1300 * US, 1500 * US),
        S("b2", 11, 1350 * US, 1450 * US),
    ]


def _trace(steps=2):
    """Kernels: two overlapping ones in the first update (150-250 and
    200-300 us: 150 us of union), one in its B2 (left out), one starting in
    the second update (1250-1400 us: counted whole), one in the predict's
    B2 (outside any update)."""
    k = [("gemm", 150 * US, 100 * US), ("trsm", 200 * US, 100 * US),
         ("downdate_kernel", 410 * US, 50 * US),
         ("getrf", 1250 * US, 150 * US),
         ("downdate_kernel", 1360 * US, 40 * US)]
    return Trace(kernels=k, device_ops=k, window_s=2e-3, busy_s=4.4e-4,
                 idle_gaps=[], top_ops=[], steps=steps)


def _read(rec):
    return {n: run.reader(n, ROOT)(rec) for n in NAMES}


def test_the_readers_on_a_synthetic_window(monkeypatch):
    monkeypatch.setattr(profiling, "window", _spans)
    got = _read({"trace": _trace()})
    assert got["frame.host_syncs_per_frame"] == 1.5
    assert got["frame.sync_wait_ms_per_frame"] == pytest.approx(0.05)
    # (500 - 100) + 200 us of update over 2 steps
    assert got["update.host_ms_per_frame"] == pytest.approx(0.3)
    # 150 + 150 us of kernels over 2 steps
    assert got["update.device_ms_per_frame"] == pytest.approx(0.15)


def test_no_host_read_reads_zero(monkeypatch):
    monkeypatch.setattr(profiling, "window", lambda: [
        s._replace(name="matcher.step") if s.name == "host_read" else s
        for s in _spans()])
    got = _read({"trace": _trace()})
    assert got["frame.host_syncs_per_frame"] == 0.0
    assert got["frame.sync_wait_ms_per_frame"] == 0.0


def test_none_without_a_trace_or_the_programs_spans(monkeypatch):
    monkeypatch.setattr(profiling, "window", _spans)
    assert set(_read({"trace": None}).values()) == {None}
    monkeypatch.setattr(profiling, "window", lambda: [])
    assert set(_read({"trace": _trace()}).values()) == {None}
    monkeypatch.delattr(profiling, "window")
    assert set(_read({"trace": _trace()}).values()) == {None}


def test_update_metrics_need_an_update_span(monkeypatch):
    monkeypatch.setattr(profiling, "window", lambda: [
        s._replace(name="frame.other") if s.name == "frame.update" else s
        for s in _spans()])
    got = _read({"trace": _trace()})
    assert got["update.host_ms_per_frame"] is None
    assert got["update.device_ms_per_frame"] is None
    assert got["frame.host_syncs_per_frame"] == 1.5
