"""The reader of ba.graph_replay_share on synthetic spans: every LM blocks
call and trial holding a "ba.graph" replay reads 1.0, some of them a
partial share, none of them 0.0; no spans, no trace, or a program that
captured no LM graph read None."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib.trace import Trace  # noqa: E402
from surikatoko_tpu_torch.utils import profiling  # noqa: E402

US = 1000
NAME = "ba.graph_replay_share"


def _trace(steps=3):
    return Trace(kernels=[], device_ops=[], window_s=3e-3, busy_s=0.0,
                 idle_gaps=[], top_ops=[], steps=steps)


def _steps(replayed):
    """Three steps of one windowed BA each: a build, a blocks call and two
    trials; the calls whose index (0-8, in order) is in ``replayed`` hold
    a "ba.graph" replay, the others the eager work's own spans."""
    S, out, c = profiling.Span, [], 0
    for k in range(3):
        t0 = 1000 * US * k
        w = len(out)
        out.append(S("ba.window", -1, t0, t0 + 900 * US))
        out.append(S("ba.build", w, t0, t0 + 100 * US))
        for j, name in enumerate(("ba.blocks", "ba.trial", "ba.trial")):
            a = t0 + 100 * US + 200 * US * j
            i = len(out)
            out.append(S(name, w, a, a + 150 * US))
            if c in replayed:
                out.append(S("ba.graph", i, a + 10 * US, a + 20 * US))
            elif name == "ba.trial":
                out.append(S("host_read", i, a + 100 * US, a + 140 * US))
            c += 1
    return out


def _read(rec):
    return run.reader(NAME, ROOT)(rec)


def _program(monkeypatch, spans, captures=2):
    monkeypatch.setattr(profiling, "window", lambda: spans)
    monkeypatch.setattr(profiling, "counts",
                        lambda: {"ba.graph_captures": captures})


def test_every_call_replayed_reads_one(monkeypatch):
    _program(monkeypatch, _steps(range(9)))
    assert _read({"trace": _trace()}) == 1.0


def test_some_calls_replayed_read_their_share(monkeypatch):
    _program(monkeypatch, _steps({2, 3, 4, 5, 6, 7, 8}))
    assert _read({"trace": _trace()}) == 7 / 9


def test_no_call_replayed_reads_zero(monkeypatch):
    _program(monkeypatch, _steps(()))
    assert _read({"trace": _trace()}) == 0.0


def test_none_without_spans_a_trace_or_graphs(monkeypatch):
    _program(monkeypatch, [])
    assert _read({"trace": _trace()}) is None
    _program(monkeypatch, _steps(range(9)))
    assert _read({"trace": None}) is None
    _program(monkeypatch, _steps(()), captures=0)
    assert _read({"trace": _trace()}) is None
    monkeypatch.setattr(profiling, "counts", lambda: {})
    assert _read({"trace": _trace()}) is None
