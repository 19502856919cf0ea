"""frame_ms_p95: the 95th percentile over every step of the window of the
time from the step's start until its camera positions are on the host."""

import numpy as np


def read(rec):
    return float(np.percentile(rec["latencies"], 95)) * 1e3
