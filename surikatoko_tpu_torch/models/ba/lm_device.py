"""The device-loop LM: the reference's damping schedule with one packed
device->host fetch per damped trial.

Port of ``surikatoko_tpu/models/ba/lm_device.py``. There the two nested
``lax.while_loop``s compile the whole LM into one TPU program. PyTorch has
no device-side loop, so here **the loop runs on the host**, and everything
of a trial stays on the card except one packed fetch of (ok, err):

  outer (running & iters < max):     recompute GN blocks at current p
    inner (no accept/stop yet):      solve damped system at `factor`,
                                     apply, evaluate the error (device);
                                     fetch (ok, err); decide (host)
      accept if err decreased        (rollback = keep the old problem)
      else damp x10, with the dtype-precision / err-limit / overflow exits

The host-driven loop (lm.py) fetches ``ok`` before it applies a step and
the error after it: two syncs per trial. This form always applies the
trial step (a failed solve gives a non-finite or rejected error) and makes
the same decisions in the same order (lm_device.py:126-181 of the JAX
package) on the fetched values, kept in the problem's dtype as the JAX
program keeps them, so it takes the same path: the same stop reason,
iterations and trials.

On a card, a one-problem run replays both pieces of device work that the
schedule does not decide from CUDA graphs (``utils/cuda_graph``, which
states the engage, warm-up, capture and naming rules): the blocks, and the
trial's solve, apply and evaluation as one graph. The schedule, its
decisions and its fetch a trial are the same in both forms.

Spans (``utils.profiling``), named by the caller's ``name`` ("ba" for
bundle adjustment): ``<name>.blocks`` (the Gauss-Newton blocks of an
iteration), ``<name>.trial`` (one damped trial: solve, apply, evaluate and
its fetch), ``<name>.graph`` inside either where it replays, and
``host_read`` around each fetch; counters ``<name>.runs``,
``<name>.iterations`` (accepted steps), ``<name>.trials``, and the graphs'
``<name>.graph_captures`` and ``<name>.graph_replays``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from surikatoko_tpu_torch.utils import cuda_graph
from surikatoko_tpu_torch.utils.profiling import count, span

STOP_RUNNING = 0
STOP_SMALL_REL_CHANGE = 1    # "small relative err change"        (ok=True)
STOP_DTYPE_PRECISION = 2     # "converged at dtype precision"     (ok=True)
STOP_ERR_LIMIT = 3           # "err converged to limit value"     (ok=False)
STOP_HESSIAN_OVERFLOW = 4    # "hessian overflow"                 (ok=False)
STOP_MAX_ITERS = 5           # "max iterations"                   (ok=True)
STOP_CANNOT_NORMALIZE = 6    # "cannot normalize ..."             (ok=False)

STOP_REASON_STR = {
    STOP_SMALL_REL_CHANGE: "small relative err change",
    STOP_DTYPE_PRECISION: "converged at dtype precision",
    STOP_ERR_LIMIT: "err converged to limit value",
    STOP_HESSIAN_OVERFLOW: "hessian overflow",
    STOP_MAX_ITERS: "max iterations",
    STOP_CANNOT_NORMALIZE: "cannot normalize (zero cam0-cam1 shift)",
}
STOP_OK = {
    STOP_SMALL_REL_CHANGE: True,
    STOP_DTYPE_PRECISION: True,
    STOP_ERR_LIMIT: False,
    STOP_HESSIAN_OVERFLOW: False,
    STOP_MAX_ITERS: True,
    STOP_CANNOT_NORMALIZE: False,
}

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _fetch(a: torch.Tensor, b: torch.Tensor):
    """Two device scalars or two [B] vectors in one device->host copy, as
    numpy vectors ([1] or [B]) of the type of ``b``."""
    with span("host_read"):
        v = torch.stack([a.to(b.dtype), b]).cpu().numpy().reshape(2, -1)
    return v[0], v[1]


class BatchedLM(NamedTuple):
    """:func:`run_lm_on_device_batched`'s result: one entry a problem, and
    the batch's rounds (each one set of launches for all problems)."""

    p: Any                 # the final problems
    code: np.ndarray       # stop codes [B]
    iters: np.ndarray      # accepted steps [B]
    err: np.ndarray        # final errors [B], in the problem's dtype
    trials: np.ndarray     # damped solves [B], rejected ones included
    outer_rounds: int      # blocks computed (the outer loop's passes)
    trial_rounds: int      # damped solves (the inner loop's passes)


def run_lm_on_device(
    p0: Any,
    *,
    blocks_fn: Callable[[Any], Any],
    solve_fn: Callable[[Any, Any, float], tuple],
    apply_fn: Callable[[Any, torch.Tensor, torch.Tensor], Any],
    err_fn: Callable[[Any], torch.Tensor],
    err_thresh: float | None,
    max_factor: float | None,
    max_iters: int,
    initial_factor: float = 1e-4,
    eps_floor_mult: float = 32.0,
    valid: torch.Tensor | None = None,
    name: str = "ba",
    graphs: cuda_graph.Store | None = None,
) -> tuple[Any, int, int, float, int]:
    """Returns (p_final, stop_code, iterations, final_err, trials) where
    ``trials`` counts every damped solve including rejected damping retries
    (``iterations`` counts only accepted steps).

    ``valid`` (optional device bool) gates the whole loop: when False the
    LM never runs and the stop code is STOP_CANNOT_NORMALIZE. It rides in
    the same fetch as the initial error. The schedule is
    :func:`run_lm_on_device_batched`'s, on one problem and its 0-d state;
    ``name`` names its spans and counters.

    Where ``p0``'s fields engage a graph (``cuda_graph.graphable``), the
    blocks and the trials replay CUDA graphs: those of ``graphs``, a
    ``cuda_graph.Store`` that its owner keeps across runs of the same
    functions, or without one, graphs captured for this run. ``solve_fn``
    then takes the factor as a 0-d tensor of the problem's dtype; elsewhere
    as a float."""
    r = _schedule(p0, (blocks_fn, solve_fn, apply_fn, err_fn), False,
                  err_thresh, max_factor, max_iters, initial_factor,
                  eps_floor_mult, valid, name, graphs)
    return r.p, r.code.item(), r.iters.item(), r.err.item(), r.trials.item()


def select(take: torch.Tensor, a: Any, b: Any) -> Any:
    """Field by field: problem i of ``a`` where ``take[i]``, else of ``b``
    (problems with a leading batch axis; with a 0-d ``take``, one
    problem). A field that is one tensor in both is passed on as it is."""
    def pick(x, y):
        if x is y:
            return x
        return torch.where(take.view(*take.shape,
                                     *([1] * (x.dim() - take.dim()))), x, y)
    return type(a)(*(pick(x, y) for x, y in zip(a, b)))


def run_lm_on_device_batched(
    p0: Any,
    *,
    blocks_fn: Callable[[Any], Any],
    solve_fn: Callable[[Any, Any, torch.Tensor], tuple],
    apply_fn: Callable[[Any, torch.Tensor, torch.Tensor], Any],
    err_fn: Callable[[Any], torch.Tensor],
    err_thresh: float | None,
    max_factor: float | None,
    max_iters: int,
    initial_factor: float = 1e-4,
    eps_floor_mult: float = 32.0,
    valid: torch.Tensor | None = None,
) -> BatchedLM:
    """:func:`run_lm_on_device` over B problems at once: ``p0`` carries a
    leading batch axis on every field, and the per-problem functions
    (``blocks_fn`` and the rest, as for one problem; ``solve_fn`` takes a
    0-d tensor factor) are mapped over it with ``torch.func.vmap``, so a
    trial is one set of launches for all B. The schedule stays on the host
    as numpy arrays, one entry a problem (factor, err, err_prev, has_prev,
    stop code, iterations, trials), and a trial makes one packed fetch of
    (ok [B], err [B]). The inner loop runs while any problem still damps,
    the outer while any runs; a problem that stopped, or accepted its step
    in this iteration, keeps its state (``torch.where``) while the others
    try on. Each problem takes the decisions its own
    :func:`run_lm_on_device` takes, in the same order, as JAX's vmapped
    ``while_loop`` does: both run this schedule.

    ``valid`` [B] (device bool) gates each problem: where False it never
    runs, keeps ``p0`` and stops with STOP_CANNOT_NORMALIZE."""
    return _schedule(p0, (blocks_fn, solve_fn, apply_fn, err_fn), True,
                     err_thresh, max_factor, max_iters, initial_factor,
                     eps_floor_mult, valid, "ba", None)


class _Eager:
    """The LM's device work called as it is: over a batch (the functions
    mapped with ``torch.func.vmap``), or for one problem that takes no
    graph."""

    def __init__(self, fns, batched: bool):
        if batched:
            fns = tuple(torch.func.vmap(f) for f in fns)
        self.blocks, self.solve_fn, self.apply_fn, self.err_fn = fns

    def trial(self, p, blocks, factor):
        """(ok, err, p_try) of the damped step at ``factor``."""
        dX, du, ok = self.solve_fn(p, blocks, factor)
        p_try = self.apply_fn(p, dX, du)
        return ok, self.err_fn(p_try), p_try

    @staticmethod
    def accept(p_try):
        return p_try

    @staticmethod
    def result(p, _p0):
        return p


class _LMGraph:
    """One key's graphs (``utils/cuda_graph``, named by the run's ``name``)
    and the static buffers they read: the problem (``p``, loaded once a run
    and replaced field by field by an accepted step) and the damping factor
    (a 0-d tensor of the problem's dtype, refilled before each trial). The
    blocks graph computes ``blocks_fn(p)``; the trial graph ``solve_fn``,
    ``apply_fn`` and ``err_fn`` on the blocks graph's outputs, giving (ok,
    err, p_try)."""

    def __init__(self, p0, fns, name: str, dtype: torch.dtype):
        self.fns = fns
        self.p = type(p0)(*(torch.empty_like(
            t, memory_format=torch.contiguous_format) for t in p0))
        dev = p0[0].device
        self.factor = torch.empty((), dtype=dtype, device=dev)
        self.blocks_graph = cuda_graph.Graph(name, dev)
        self.trial_graph = cuda_graph.Graph(name, dev)
        self.varying = None   # the fields of p that a step replaces

    def load(self, p0):
        for dst, src in zip(self.p, p0):
            dst.copy_(src)
        return self.p

    def blocks(self, _p):
        return self.blocks_graph(lambda: self.fns[0](self.p))

    def trial(self, _p, blocks, factor: float):
        solve_fn, apply_fn, err_fn = self.fns[1:]

        def work():
            dX, du, ok = solve_fn(self.p, blocks, self.factor)
            p_try = apply_fn(self.p, dX, du)
            return ok, err_fn(p_try), p_try
        self.factor.fill_(factor)
        ok, err, p_try = self.trial_graph(work)
        if self.varying is None:
            self.varying = [i for i, (a, b) in enumerate(zip(p_try, self.p))
                            if a is not b]
        return ok, err, p_try

    def accept(self, p_try):
        """The step's fields copied into ``p``, where the next blocks read
        them (device to device)."""
        for i in self.varying:
            self.p[i].copy_(p_try[i])
        return self.p

    def result(self, p, p0):
        """The run's problem, the caller's own: the fields a step replaces
        cloned from ``p`` (a later run overwrites it), the others
        ``p0``'s."""
        return type(p0)(*(p[i].clone() if i in self.varying else t
                          for i, t in enumerate(p0)))


# a failed trial's error may be inf or nan: ``ok`` masks it out of every
# decision, so numpy's warnings about it say nothing
@np.errstate(invalid="ignore", over="ignore")
def _schedule(p0, fns, batched: bool, err_thresh, max_factor, max_iters,
              initial_factor, eps_floor_mult, valid, name: str,
              graphs) -> BatchedLM:
    """The LM schedule over a batch (the functions mapped with
    ``torch.func.vmap``, the factor a [B] tensor) or over one problem
    (``batched`` False: its state is numpy vectors of one entry, the factor
    reaches ``solve_fn`` as a float, or as a 0-d tensor where the run
    replays ``graphs``' graphs, :func:`run_lm_on_device`); ``name``
    prefixes its spans and counters."""
    work = _Eager(fns, batched)
    err0 = work.err_fn(p0)
    dev = err0.device
    npd = _NP_DTYPE[err0.dtype]
    if valid is None:
        valid = torch.ones(err0.shape, dtype=torch.bool, device=dev)
    ok0, err = _fetch(valid, err0)
    shape = err.shape
    code = np.where(ok0 != 0, STOP_RUNNING, STOP_CANNOT_NORMALIZE)
    p = p0
    if (not batched and (code == STOP_RUNNING).all()
            and cuda_graph.graphable(p0)):
        work = (graphs or cuda_graph.Store()).get(
            cuda_graph.key(p0), lambda: _LMGraph(p0, fns, name, err0.dtype))
        p = work.load(p0)
    eps_floor = npd(eps_floor_mult * float(np.finfo(npd).eps))
    # no |change| is below -inf and no factor above +inf: a criterion given
    # as None never fires
    thresh = -np.inf if err_thresh is None else err_thresh
    cap = np.inf if max_factor is None else max_factor
    factor = np.full(shape, initial_factor, npd)
    iters = np.zeros(shape, np.int64)
    trials = np.zeros(shape, np.int64)
    outer_rounds = trial_rounds = 0

    def factor_arg(f):
        return (torch.as_tensor(f, dtype=err0.dtype, device=dev) if batched
                else f.item())

    while (code == STOP_RUNNING).any():
        with span(name + ".blocks"):
            blocks = work.blocks(p)
        outer_rounds += 1
        damping = code == STOP_RUNNING
        has_prev = np.zeros(shape, bool)
        err_prev = np.zeros(shape, npd)
        accepted = np.zeros(shape, bool)
        err_acc = err.copy()
        p_acc = p
        # host loop order (lm.py): decrease -> dtype floor -> err limit ->
        # damp (overflow check after damping)
        while damping.any():
            with span(name + ".trial"):
                ok, err_new, p_try = work.trial(p, blocks, factor_arg(factor))
                ok, err_new = _fetch(ok, err_new)
            trial_rounds += 1
            trials += damping
            # a trial that counts: solved, finite, of a damping problem
            ok = (ok != 0) & np.isfinite(err_new) & damping
            decreased = ok & (err_new < err)
            rest = ok & ~decreased
            diff = err_new - err
            dtype_conv = rest & (diff >= 0) & (diff <= eps_floor * err)
            limit = (rest & ~dtype_conv & has_prev
                     & (np.abs(err_new - err_prev) < thresh))
            err_prev = np.where(ok, err_new, err_prev)
            has_prev = has_prev | ok
            if decreased.all():
                # every problem accepts this trial (one problem always does
                # when it decreases): no selection needed
                p_acc = work.accept(p_try)
            elif decreased.any():
                p_acc = select(torch.as_tensor(decreased, device=dev), p_try,
                               p_acc)
            err_acc = np.where(decreased, err_new, err_acc)
            accepted = accepted | decreased
            # the others damp on, unless their error stopped them; the
            # factor beyond the cap (after damping) stops them too
            failed = damping & ~decreased
            next_factor = factor * npd(10.0)
            factor = np.where(failed, next_factor, factor)
            damping = failed & ~(dtype_conv | limit)
            overflow = damping & (next_factor > cap)
            damping = damping & ~overflow
            code = np.where(dtype_conv, STOP_DTYPE_PRECISION,
                            np.where(limit, STOP_ERR_LIMIT,
                                     np.where(overflow, STOP_HESSIAN_OVERFLOW,
                                              code)))
        p = p_acc
        iters = iters + accepted
        small_rel = accepted & (np.abs(err_acc - err) < thresh)
        err = np.where(accepted, err_acc, err)
        factor = np.where(accepted, factor / npd(10.0), factor)
        code = np.where(small_rel, STOP_SMALL_REL_CHANGE,
                        np.where(accepted & (iters >= max_iters),
                                 STOP_MAX_ITERS, code))
    count(name + ".runs", code.size)
    count(name + ".iterations", int(iters.sum()))
    count(name + ".trials", int(trials.sum()))
    return BatchedLM(work.result(p, p0), code, iters, err, trials,
                     outer_rounds, trial_rounds)
