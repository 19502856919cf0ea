"""b2.roofline_pct: kernel B2's share of its roofline. The bound of the
calls (``downdate_work`` at the cell's B, D, m, over the published float32
rate and memory bandwidth) over the device time of B2's kernels in the
trace: the downdate itself and, at 128-wide tiles, the row-padding copy of
the same call. The unbatched call reaches the library straight, with no
dispatcher op around it, so the kernels are found by name. None without a
B2 launch in the trace."""

from benchmark.lib.work import bound_s, downdate_work

CALL = "downdate_kernel"          # one a call
PART_OF_CALL = ("downdate_kernel", "pad_rows")


def read(rec):
    t, w = rec["trace"], rec["work"].get("b2")
    if t is None or w is None:
        return None
    ks = [k for k in t.kernels if any(n in k[0] for n in PART_OF_CALL)]
    calls = sum(CALL in k[0] for k in ks)
    if not calls:
        return None
    dev_s = sum(k[2] for k in ks) * 1e-9
    return 100.0 * calls * bound_s(*downdate_work(w["D"], w["m"], True,
                                                  w["B"])) / dev_s
