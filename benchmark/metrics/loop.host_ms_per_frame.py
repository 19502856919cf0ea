"""loop.host_ms_per_frame: mean milliseconds a step in the host's enqueue of one runner call (the benchmark's span around it, ending before the pose read), over the window's steps outside the
profiled ones. None where the cell records no such span."""

SPAN = "loop"


def read(rec):
    d = rec["spans"].get(SPAN)
    return 1e3 * sum(d) / len(d) if d else None
