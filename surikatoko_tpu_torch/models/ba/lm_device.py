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

from typing import Any, Callable

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


def _fetch(a: torch.Tensor, b: torch.Tensor, np_dtype):
    """Two device scalars in one device->host copy, as np_dtype scalars."""
    v = torch.stack([a.to(b.dtype), b]).cpu().numpy()
    return np_dtype(v[0]), np_dtype(v[1])


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
    the same fetch as the initial error."""
    err0 = err_fn(p0)
    npd = _NP_DTYPE[err0.dtype]
    if valid is None:
        valid = torch.ones((), dtype=torch.bool, device=err0.device)
    ok0, err = _fetch(valid, err0, npd)
    code = STOP_RUNNING if ok0 else STOP_CANNOT_NORMALIZE
    eps_floor = npd(eps_floor_mult * float(np.finfo(npd).eps))
    factor = npd(initial_factor)
    p, iters, trials = p0, 0, 0

    while code == STOP_RUNNING:
        blocks = blocks_fn(p)
        has_prev, err_prev = False, npd(0)
        while True:
            dX, du, ok = solve_fn(p, blocks, float(factor))
            p_try = apply_fn(p, dX, du)
            ok, err_new = _fetch(ok, err_fn(p_try), npd)
            ok = bool(ok) and bool(np.isfinite(err_new))
            trials += 1
            decreased = ok and err_new < err
            # host loop order (lm.py): decrease -> dtype floor -> err limit
            # -> damp (overflow check after damping)
            diff = err_new - err
            dtype_conv = (ok and not decreased and diff >= 0
                          and diff <= eps_floor * err)
            limit = (err_thresh is not None and ok and not decreased
                     and not dtype_conv and has_prev
                     and abs(err_new - err_prev) < err_thresh)
            next_factor = factor * npd(10.0)
            stop_damping = decreased or dtype_conv or limit
            overflow = (max_factor is not None and not stop_damping
                        and next_factor > max_factor)
            if ok:
                err_prev, has_prev = err_new, True
            if decreased:
                break
            factor = next_factor
            if dtype_conv or limit or overflow:
                code = (STOP_DTYPE_PRECISION if dtype_conv else
                        STOP_ERR_LIMIT if limit else STOP_HESSIAN_OVERFLOW)
                break
        if code != STOP_RUNNING:
            break
        iters += 1
        small_rel = err_thresh is not None and abs(err_new - err) < err_thresh
        p, err = p_try, err_new
        factor = factor / npd(10.0)
        if small_rel:
            code = STOP_SMALL_REL_CHANGE
        elif iters >= max_iters:
            code = STOP_MAX_ITERS
    return p, code, iters, float(err), trials
