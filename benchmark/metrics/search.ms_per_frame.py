"""search.ms_per_frame: the program's "frame.search" spans (the gated NCC
search: the search patches and the gate, kernel B1, the best centres)
summed over the traced steps, over those steps. None without a trace or
without such spans."""

from benchmark.lib import program_spans

SPAN = "frame.search"


def read(rec):
    t, spans = rec["trace"], program_spans.window()
    if t is None or not t.steps or spans is None:
        return None
    ii = program_spans.named(spans, SPAN)
    if not ii:
        return None
    return sum(spans[i][3] - spans[i][2] for i in ii) * 1e-6 / t.steps
