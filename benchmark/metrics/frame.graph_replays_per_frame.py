"""frame.graph_replays_per_frame: the program's "frame.graph" spans (one
around each replay of a frame's CUDA graph by the scan runners) in the
traced steps, over those steps: 1.0 where every step replays one graph; 0
where the program's spans are recorded and none is a replay. None without
a trace or without the program's spans."""

from benchmark.lib import program_spans


def read(rec):
    t, spans = rec["trace"], program_spans.window()
    if t is None or not t.steps or spans is None:
        return None
    return len(program_spans.named(spans, "frame.graph")) / t.steps
