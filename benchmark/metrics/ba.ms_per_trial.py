"""ba.ms_per_trial: the mean of the program's "ba.trial" spans in the
traced steps (one damped LM trial: the solve, the step applied, the cost
evaluated and its fetch). None without a trace or without such spans."""

from benchmark.lib import program_spans


def read(rec):
    t, spans = rec["trace"], program_spans.window()
    if t is None or spans is None:
        return None
    ii = program_spans.named(spans, "ba.trial")
    if not ii:
        return None
    return sum(spans[i][3] - spans[i][2] for i in ii) * 1e-6 / len(ii)
