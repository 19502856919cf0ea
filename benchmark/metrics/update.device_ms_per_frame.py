"""update.device_ms_per_frame: the device time of the measurement update a
traced step: the union of the trace's kernels that start on the device
inside a "frame.update" span of the program and outside its "b2" child
(the innovation's Cholesky, getrf/potrf, its triangular solve, trsm, the
H P and gain products and their elementwise kernels), over the traced
steps. The spans are host intervals, so the attribution is by start time:
a kernel launched near the end of the span can start after it (missed),
and one launched just before it can start inside (counted). In the
benchmark's loops, idle 94-96% of the time, the lag is at most the longest
queued kernel, about 50 us. None without a trace or without such spans."""

import bisect

from benchmark.lib import program_spans
from benchmark.lib.trace import union


def read(rec):
    t, spans = rec["trace"], program_spans.window()
    if t is None or not t.steps or spans is None:
        return None
    ups = program_spans.named(spans, "frame.update")
    if not ups:
        return None
    ks = sorted((s, s + d) for _, s, d in t.kernels)
    starts = [k[0] for k in ks]
    picked = []
    for i in ups:
        lo, hi = spans[i][2], spans[i][3]
        b2 = program_spans.inside(spans, i, "b2")
        for k in ks[bisect.bisect_left(starts, lo):
                    bisect.bisect_left(starts, hi)]:
            if not any(s <= k[0] < e for s, e in b2):
                picked.append(k)
    return sum(e - s for s, e in union(picked)) * 1e-6 / t.steps
