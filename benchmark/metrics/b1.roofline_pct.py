"""b1.roofline_pct: kernel B1's share of its roofline. The bound of the
calls (``ncc_work`` at the cell's K, P, T, over the published float32
rate and memory bandwidth) over the device time of B1's kernels in the
trace, found by name (one launch a call). None without a B1 launch in the
trace."""

from benchmark.lib.work import bound_s, ncc_work

KERNEL = "ncc_search_kernel"


def read(rec):
    t, w = rec["trace"], rec["work"].get("b1")
    if t is None or w is None:
        return None
    ks = [k for k in t.kernels if KERNEL in k[0]]
    if not ks:
        return None
    dev_s = sum(k[2] for k in ks) * 1e-9
    return 100.0 * len(ks) * bound_s(*ncc_work(w["K"], w["P"], w["T"])) / dev_s
