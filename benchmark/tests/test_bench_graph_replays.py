"""The reader of frame.graph_replays_per_frame on synthetic spans: one
"frame.graph" span a traced step reads 1.0, program spans without one read
0.0, and no spans (or no trace) read None."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib.trace import Trace  # noqa: E402
from surikatoko_tpu_torch.utils import profiling  # noqa: E402

US = 1000
NAME = "frame.graph_replays_per_frame"


def _trace(steps=3):
    return Trace(kernels=[], device_ops=[], window_s=3e-3, busy_s=0.0,
                 idle_gaps=[], top_ops=[], steps=steps)


def _frames(graphed: bool):
    """Three steps, each a frame span with a replay inside (``graphed``) or
    the eager frame's match and update spans."""
    S, out = profiling.Span, []
    for k in range(3):
        t0 = 1000 * US * k
        i = len(out)
        out.append(S("frame", -1, t0, t0 + 500 * US))
        if graphed:
            out.append(S("frame.graph", i, t0 + 100 * US, t0 + 200 * US))
        else:
            out += [S("frame.match", i, t0 + 10 * US, t0 + 50 * US),
                    S("frame.update", i, t0 + 50 * US, t0 + 400 * US)]
    return out


def _read(rec):
    return run.reader(NAME, ROOT)(rec)


def test_one_replay_a_step_reads_one(monkeypatch):
    monkeypatch.setattr(profiling, "window", lambda: _frames(True))
    assert _read({"trace": _trace()}) == 1.0


def test_spans_without_a_replay_read_zero(monkeypatch):
    monkeypatch.setattr(profiling, "window", lambda: _frames(False))
    assert _read({"trace": _trace()}) == 0.0


def test_none_without_spans_or_a_trace(monkeypatch):
    monkeypatch.setattr(profiling, "window", lambda: [])
    assert _read({"trace": _trace()}) is None
    monkeypatch.setattr(profiling, "window", lambda: _frames(True))
    assert _read({"trace": None}) is None
    monkeypatch.delattr(profiling, "window")
    assert _read({"trace": _trace()}) is None
