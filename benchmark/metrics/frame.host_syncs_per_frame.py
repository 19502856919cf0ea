"""frame.host_syncs_per_frame: the program's transfers that make the host
wait for the card (its "host_read" spans: device-to-host reads and copies
from pageable host memory) in the traced steps, over those steps. A count;
0 where the program's spans are recorded and none is a read. None without
a trace or without the program's spans."""

from benchmark.lib import program_spans


def read(rec):
    t, spans = rec["trace"], program_spans.window()
    if t is None or not t.steps or spans is None:
        return None
    return len(program_spans.named(spans, "host_read")) / t.steps
