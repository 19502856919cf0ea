"""update.host_ms_per_frame: the host's self time of the measurement
update a traced step: each "frame.update" span of the program (Jacobians,
H P, the innovation, its Cholesky and triangular solve, the correction)
less what its "b2" child covers (the downdate inside ``stacked_update``;
the fused step's downdate lies outside the update), summed over the traced
steps and divided by them. None without a trace or without such spans."""

from benchmark.lib import program_spans


def read(rec):
    t, spans = rec["trace"], program_spans.window()
    if t is None or not t.steps or spans is None:
        return None
    ups = program_spans.named(spans, "frame.update")
    if not ups:
        return None
    ns = 0
    for i in ups:
        ns += spans[i][3] - spans[i][2]
        ns -= sum(e - s for s, e in program_spans.inside(spans, i, "b2"))
    return ns * 1e-6 / t.steps
