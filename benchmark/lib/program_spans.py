"""The program's own spans of a traced run (``span`` of
``surikatoko_tpu_torch.utils.profiling``), for the per-layer metrics that
read them. The spans are on the profiler's clock, so they line up with the
kernels of the reduced trace (``lib/trace.py``). A program without them
(no ``window`` in its profiling module, or none recorded) gives None."""

from __future__ import annotations

from benchmark.lib.trace import union


def window():
    """The latest profiler session's closed spans, as (name, parent,
    start_ns, end_ns) in the order they opened, or None."""
    try:
        from surikatoko_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "window", None)
    spans = read() if read is not None else None
    if not spans:
        return None
    return [tuple(s) for s in spans]


def named(spans, name: str) -> list:
    """Indices of the closed spans called ``name``."""
    return [i for i, s in enumerate(spans) if s[0] == name and s[3] >= s[2]]


def inside(spans, i: int, name: str) -> list:
    """[start, end) of the closed spans called ``name`` below span ``i``,
    clipped to it, merged."""
    lo, hi = spans[i][2], spans[i][3]
    out = []
    for j in range(i + 1, len(spans)):
        s = spans[j]
        if s[0] != name or s[3] < s[2]:
            continue
        k = s[1]
        while k > i:            # a parent opens before its children
            k = spans[k][1] if spans[k][1] < k else -1
        if k == i:
            out.append((max(s[2], lo), min(s[3], hi)))
    return union([iv for iv in out if iv[1] > iv[0]])
