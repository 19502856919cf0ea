"""frame.mfu: the whole frame's share of the card's float32 peak over the
traced window: the frame's dense linear algebra counted from shapes
(``frame_fma``: H P, the innovation, its Cholesky and triangular solve, the
downdate) times the traced steps, over the traced window's length in the
trace and the published float32 FMA rate. A lower bound of the frame's
work, so a kernel's roofline cannot improve past what the whole frame
shows. None without a trace."""

from benchmark.lib.work import F32_FMA_PER_S


def read(rec):
    t = rec["trace"]
    if t is None or not t.steps or t.window_s <= 0:
        return None
    return 100.0 * rec["work"]["frame_fma"] * t.steps / t.window_s / F32_FMA_PER_S
