"""matcher.ms_per_frame: mean milliseconds a step in the demo matcher's two calls a frame (match_salient_points, recruit_new_salient_points), over the window's steps outside the
profiled ones. None where the cell records no such span."""

SPAN = "matcher"


def read(rec):
    d = rec["spans"].get(SPAN)
    return 1e3 * sum(d) / len(d) if d else None
