"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's operations (kernels, copies, fills) inside the traced
window, their union (busy time), the idle gaps between them attributed to
the host operation that was running, and the operations that took most
time. Events stay in memory; no trace file is written."""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

WINDOW_SPAN = "bench.traced"


class Trace(NamedTuple):
    kernels: list        # [(name, start_ns, dur_ns)] device kernels
    device_ops: list     # [(name, start_ns, dur_ns)] kernels, copies, fills
    window_s: float
    busy_s: float
    idle_gaps: list      # [(host op, seconds)], most first
    top_ops: list        # [(device op, seconds)], most first
    steps: int           # loop steps traced


def union(intervals: list) -> list:
    """Merged [start, end) intervals of ``intervals`` (any order)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, steps: int, top: int = 10) -> Trace:
    """``events``: (name, kind, start_ns, dur_ns) of every event of the
    profile, kind "kernel" or "copy" (device operations) or "host"; the
    window is the host span named WINDOW_SPAN."""
    win = [(s, s + d) for n, kind, s, d in events
           if kind == "host" and n == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    w0, w1 = win[0]
    dev_ops, kernels, host = [], [], []
    for n, kind, s, d in events:
        if not (s < w1 and s + d > w0):
            continue
        if kind == "host":
            if n != WINDOW_SPAN:
                host.append((s, s + d, n))
            continue
        op = (n, max(s, w0), min(s + d, w1) - max(s, w0))
        dev_ops.append(op)
        if kind == "kernel":
            kernels.append(op)
    busy = union([(s, s + d) for _, s, d in dev_ops])
    busy_ns = sum(e - s for s, e in busy)
    # idle gaps inside the window, each charged to the innermost host
    # operation running when it began (the one that started last)
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    host.sort()
    idle = defaultdict(float)
    j, open_ = 0, []
    for g0, g1 in gaps:
        while j < len(host) and host[j][0] <= g0:
            open_.append(host[j])
            j += 1
        open_ = [h for h in open_ if h[1] > g0]
        name = max(open_)[2] if open_ else "(host, outside any operation)"
        idle[name] += (g1 - g0) * 1e-9
    by_op = defaultdict(float)
    for n, _, d in dev_ops:
        by_op[n] += d * 1e-9
    rank = lambda dct: sorted(dct.items(), key=lambda kv: -kv[1])[:top]
    return Trace(kernels=kernels, device_ops=dev_ops, window_s=(w1 - w0) * 1e-9,
                 busy_s=busy_ns * 1e-9, idle_gaps=rank(idle),
                 top_ops=rank(by_op), steps=steps)


def events_of(prof) -> list:
    """(name, kind, start_ns, dur_ns) of a finished profile's events: the
    device's kernels, copies and fills, and every host event. A host span
    (user annotation) also appears on the device's timeline under its own
    name; that is no device work and is left out."""
    evs = prof.profiler.kineto_results.events()
    spans = {e.name() for e in evs
             if e.device_type().name != "CUDA" and e.is_user_annotation()}
    out = []
    for e in evs:
        name = e.name()
        if e.device_type().name != "CUDA":
            kind = "host"
        elif name in spans or e.is_user_annotation():
            continue
        elif name.startswith(("Memcpy", "Memset")):
            kind = "copy"
        else:
            kind = "kernel"
        out.append((name, kind, e.start_ns(), e.duration_ns()))
    return out
