"""What every driver shares: the spans the benchmark records around its
calls into the program, the comparison of a program state with the
reference's, and the precision switch of the control."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch.profiler import record_function


class Spans:
    """Host-clock spans around calls into the program's layers, one list of
    seconds a name; each also appears in a profile as a user annotation.
    ``step`` is the loop step they belong to (-1: set-up)."""

    def __init__(self):
        self.records = []          # (step, name, seconds)
        self.step = -1

    @contextlib.contextmanager
    def __call__(self, name: str):
        with record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.records.append((self.step, name,
                                     time.perf_counter() - t0))

    def by_name(self, steps) -> dict:
        steps = set(steps)
        out = defaultdict(list)
        for s, n, d in self.records:
            if s in steps:
                out[n].append(d)
        return dict(out)


def state_errs(prog, ref) -> dict:
    """Numbers compared between a program state and the reference's, both
    (x, P, lm_active, lm_unobserved, lm_generation) with any leading batch:
    ``x_err`` the largest |x difference|; ``P_err`` the largest |P
    difference| over the reference's largest |P| and, in the camera's 13
    rows, over the reference's largest camera variance (new landmarks'
    variances dwarf the camera's, whose rows every update moves); and
    ``bookkeeping_mismatch`` the slot flags and counters that differ."""
    x_p, x_r = prog.x.double(), ref.x.double().to(prog.x.device)
    P_p, P_r = prog.P.double(), ref.P.double().to(prog.P.device)
    book = sum(int((getattr(prog, k).to(x_p.device)
                    != getattr(ref, k).to(x_p.device)).sum())
               for k in ("lm_active", "lm_unobserved", "lm_generation"))
    dP = (P_p - P_r).abs()
    ratio = lambda num, den: float(num) / max(float(den), 1e-300)
    P_err = max(ratio(dP.max(), P_r.abs().max()),
                ratio(dP[..., :13, :].max(), P_r[..., :13, :13].abs().max()))
    return {"x_err": float((x_p - x_r).abs().max()),
            "P_err": P_err,
            "bookkeeping_mismatch": book}


def merge(into: dict, readings: dict) -> dict:
    """Worst reading of each number (NaN counts as worst)."""
    for k, v in readings.items():
        v = float("inf") if v != v else v
        into[k] = max(into.get(k, v), v)
    return into


def worst(readings: list) -> dict:
    """The program's numbers: the worst of each over the judged steps."""
    out = {}
    for r in readings:
        merge(out, r)
    return out


def worst_finite(readings: list) -> dict:
    """The control's numbers: the worst of each over the judged steps
    whose numbers are all finite (a control step that gives no number has
    failed, and sets no upper reading), with the count of the others as
    ``nonfinite_steps``."""
    finite = [r for r in readings
              if all(v == v and abs(v) != float("inf") for v in r.values())]
    out = worst(finite)
    out["nonfinite_steps"] = len(readings) - len(finite)
    return out


@contextlib.contextmanager
def tf32():
    """float32 matmuls and convolutions in TF32: the precision below the
    configurations' float32 (TF32 off), in which the control runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def lower_precision(cfg: dict):
    """(dtype, context) in which the control runs: the precision below the
    configuration's, float32 with TF32 for float32 (TF32 off), float32
    for float64."""
    if cfg["dtype"] == "float64":
        return torch.float32, contextlib.nullcontext
    return torch.float32, tf32


def full_precision() -> None:
    """float32 as the configurations state it: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
