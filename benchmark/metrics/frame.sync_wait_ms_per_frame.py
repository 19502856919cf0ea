"""frame.sync_wait_ms_per_frame: milliseconds a traced step in the
program's "host_read" spans (the host waiting for the card, and the copy
itself), summed, over the traced steps. None without a trace or without
the program's spans."""

from benchmark.lib import program_spans


def read(rec):
    t, spans = rec["trace"], program_spans.window()
    if t is None or not t.steps or spans is None:
        return None
    ns = sum(spans[i][3] - spans[i][2]
             for i in program_spans.named(spans, "host_read"))
    return ns * 1e-6 / t.steps
