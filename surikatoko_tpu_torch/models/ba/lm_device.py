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
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

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
) -> tuple[Any, int, int, float, int]:
    """Returns (p_final, stop_code, iterations, final_err, trials) where
    ``trials`` counts every damped solve including rejected damping retries
    (``iterations`` counts only accepted steps).

    ``valid`` (optional device bool) gates the whole loop: when False the
    LM never runs and the stop code is STOP_CANNOT_NORMALIZE. It rides in
    the same fetch as the initial error. The schedule is
    :func:`run_lm_on_device_batched`'s, on one problem and its 0-d state."""
    r = _schedule(p0, (blocks_fn, solve_fn, apply_fn, err_fn), False,
                  err_thresh, max_factor, max_iters, initial_factor,
                  eps_floor_mult, valid)
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
                     eps_floor_mult, valid)


# a failed trial's error may be inf or nan: ``ok`` masks it out of every
# decision, so numpy's warnings about it say nothing
@np.errstate(invalid="ignore", over="ignore")
def _schedule(p0, fns, batched: bool, err_thresh, max_factor, max_iters,
              initial_factor, eps_floor_mult, valid) -> BatchedLM:
    """The LM schedule over a batch (the functions mapped with
    ``torch.func.vmap``, the factor a [B] tensor) or over one problem
    (``batched`` False: its state is numpy vectors of one entry, the factor
    reaches ``solve_fn`` as a float)."""
    if batched:
        fns = tuple(torch.func.vmap(f) for f in fns)
    blocks_fn, solve_fn, apply_fn, err_fn = fns
    err0 = err_fn(p0)
    dev = err0.device
    npd = _NP_DTYPE[err0.dtype]
    if valid is None:
        valid = torch.ones(err0.shape, dtype=torch.bool, device=dev)
    ok0, err = _fetch(valid, err0)
    shape = err.shape
    code = np.where(ok0 != 0, STOP_RUNNING, STOP_CANNOT_NORMALIZE)
    eps_floor = npd(eps_floor_mult * float(np.finfo(npd).eps))
    # no |change| is below -inf and no factor above +inf: a criterion given
    # as None never fires
    thresh = -np.inf if err_thresh is None else err_thresh
    cap = np.inf if max_factor is None else max_factor
    factor = np.full(shape, initial_factor, npd)
    iters = np.zeros(shape, np.int64)
    trials = np.zeros(shape, np.int64)
    outer_rounds = trial_rounds = 0
    p = p0

    def factor_arg(f):
        return (torch.as_tensor(f, dtype=err0.dtype, device=dev) if batched
                else f.item())

    while (code == STOP_RUNNING).any():
        blocks = blocks_fn(p)
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
            dX, du, ok = solve_fn(p, blocks, factor_arg(factor))
            p_try = apply_fn(p, dX, du)
            ok, err_new = _fetch(ok, err_fn(p_try))
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
                p_acc = p_try
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
    return BatchedLM(p, code, iters, err, trials, outer_rounds, trial_rounds)
