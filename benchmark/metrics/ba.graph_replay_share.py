"""ba.graph_replay_share: the share of the program's "ba.blocks" and
"ba.trial" spans in the traced steps that hold a "ba.graph" span, a replay
of a CUDA graph of the LM's blocks or trial that an earlier call captured:
1.0 where every Gauss-Newton blocks call and every damped trial replays,
lower for the calls that ran eagerly or captured. None without a trace,
without such spans, or where the program captures no LM graph (it has no
"ba.graph_captures" counter: a program without LM graphs, or off a
card)."""

from benchmark.lib import program_spans


def _captures() -> int:
    try:
        from surikatoko_tpu_torch.utils import profiling
    except ImportError:
        return 0
    counts = getattr(profiling, "counts", None)
    return counts().get("ba.graph_captures", 0) if counts is not None else 0


def read(rec):
    t, spans = rec["trace"], program_spans.window()
    if t is None or spans is None or not _captures():
        return None
    ii = (program_spans.named(spans, "ba.blocks")
          + program_spans.named(spans, "ba.trial"))
    if not ii:
        return None
    # the program opens a replay's span directly inside its call's
    held = {spans[j][1] for j in program_spans.named(spans, "ba.graph")}
    return sum(1 for i in ii if i in held) / len(ii)
