"""filter.ms_per_frame: mean milliseconds a step in process_frame and the matcher's slot bookkeeping, over the window's steps outside the
profiled ones. None where the cell records no such span."""

SPAN = "filter"


def read(rec):
    d = rec["spans"].get(SPAN)
    return 1e3 * sum(d) / len(d) if d else None
