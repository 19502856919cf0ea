"""Levenberg-Marquardt loops with the reference's damping schedule.

Port of ``surikatoko_tpu/models/ba/lm.py`` (reference
ComputeOnNormalizedWorld, bundle-adj-kanatani.cpp:720-893): hessian_factor
starts at 1e-4; on a successful decrease it divides by 10, on failure
multiplies by 10 and retries from the snapshot; stops on a small |err
change| ("small relative err change"), damping overflow ("hessian
overflow"), or the error converging to a limit ("err converged to limit
value"). ``compute_inplace`` mirrors the reference entry point:
normalize -> optimize -> revert.

Two forms of the loop, as in the JAX package: the host form below fetches
``ok`` and then the error of every trial; ``device_loop=True`` runs
lm_device.run_lm_on_device, one packed fetch per trial, with the gauge
check, normalization and revert on the device around it. Both take the
same path. Both record the spans ``ba.blocks`` and ``ba.trial`` and the
counters ``ba.runs``, ``ba.iterations`` and ``ba.trials`` (lm_device.py);
``ba.build`` marks the band plan.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from surikatoko_tpu_torch.models.ba import derivs, lm_device, normalize, schur
from surikatoko_tpu_torch.models.ba import sparse as sp
from surikatoko_tpu_torch.models.ba.problem import BAProblem, reproj_error
from surikatoko_tpu_torch.utils.profiling import count, span


@dataclass
class TermCriteria:
    """Reference BundleAdjustmentKanataniTermCriteria (h:68-96)."""

    allowed_reproj_err_rel_change: Optional[float] = None
    max_hessian_factor: Optional[float] = 1e12
    max_iters: int = 300


# a cam0-cam1 shift at most this long in the gauge's unity component
# cannot be normalized
GAUGE_MIN_SHIFT = 1e-5


def _lm_limits(term_crit: TermCriteria) -> dict:
    return dict(err_thresh=term_crit.allowed_reproj_err_rel_change,
                max_factor=term_crit.max_hessian_factor,
                max_iters=term_crit.max_iters)


def _in_gauge(p, lm, t1y: float, uci: int, batched: bool = False):
    """validity check -> normalize -> ``lm(p_normalized, valid)`` ->
    revert, on the device; with ``batched`` each step is mapped over the
    problems' leading axis with ``torch.func.vmap`` (the gauge's unity
    component, a Python int, stays outside it). A problem with a degenerate
    gauge (``valid`` False; the LM refuses it) comes back untouched. Returns
    ``lm``'s result with its problem in the original gauge."""
    vmap = torch.func.vmap if batched else (lambda f: f)

    def norm(q):
        valid = torch.abs(normalize._t01(q.cfw_R, q.cfw_t)[uci]) > GAUGE_MIN_SHIFT
        q_n, ns = normalize.normalize_scene(q, t1y=t1y, unity_comp_ind=uci,
                                            min_shift=GAUGE_MIN_SHIFT)
        return valid, q_n, (ns.R0, ns.T0, ns.world_scale)

    def revert(q, gauge):
        return normalize.revert_normalization(q, normalize.NormState(*gauge, uci))

    valid, p_n, gauge = vmap(norm)(p)
    res = lm(p_n, valid)
    return (lm_device.select(valid, vmap(revert)(res[0], gauge), p),
            *res[1:])


def _run_device_loop(ba, p, term_crit: TermCriteria, blocks_fn, solve_fn,
                     apply_fn, err_fn, gauge=None):
    """Run lm_device.run_lm_on_device and map its stop code onto the
    BA object's (ok, stop_reason, iterations, trials) reporting.

    ``gauge`` (optional, (t1y, unity_comp_ind)) wraps the LM in the gauge
    transform (:func:`_in_gauge`), with the validity flag in the LM's first
    fetch. A degenerate gauge comes back untouched with stop code "cannot
    normalize"."""
    def lm(q, valid=None):
        return lm_device.run_lm_on_device(
            q, blocks_fn=blocks_fn, solve_fn=solve_fn, apply_fn=apply_fn,
            err_fn=err_fn, valid=valid, **_lm_limits(term_crit))
    p_out, code, iters, _, trials = (lm(p) if gauge is None
                                     else _in_gauge(p, lm, *gauge))
    ba.iterations = iters
    ba.trials = trials
    ba.stop_reason = lm_device.STOP_REASON_STR.get(code, "")
    return lm_device.STOP_OK.get(code, True), p_out


def _host_loop(ba, p, term_crit: TermCriteria, blocks_fn, solve_fn,
               apply_fn, err_fn):
    """The host-driven LM (lm.py:192-243 of the JAX package): a blocking
    fetch of ``ok``, then of the trial error, per damped solve."""
    count("ba.runs")
    hessian_factor = 1e-4
    with span("host_read"):
        err_value = float(err_fn(p))
    err_thresh = term_crit.allowed_reproj_err_rel_change
    # dtype-aware convergence floor: once a (damped) trial step changes the
    # error by less than a few ulps of the error itself, no further progress
    # is representable — declare convergence instead of damping up to
    # "hessian overflow" (the reference is always f64, rt-config.h:42)
    eps_floor = 32.0 * float(torch.finfo(p.points.dtype).eps)
    ba.iterations = 0
    ba.trials = 0
    for _ in range(term_crit.max_iters):
        with span("ba.blocks"):
            blocks = blocks_fn(p)
        err_new_prev = None
        while True:
            with span("ba.trial"):
                dX, du, ok = solve_fn(p, blocks, hessian_factor)
                with span("host_read"):
                    ok = bool(ok)
                if ok:
                    p_try = apply_fn(p, dX, du)
                    with span("host_read"):
                        err_new = float(err_fn(p_try))
            ba.trials += 1
            count("ba.trials")
            if ok:
                if err_new < err_value:
                    p = p_try
                    break
                if 0.0 <= err_new - err_value <= eps_floor * err_value:
                    ba.stop_reason = "converged at dtype precision"
                    return True, p
                if (err_new_prev is not None and err_thresh is not None
                        and abs(err_new - err_new_prev) < err_thresh):
                    ba.stop_reason = "err converged to limit value"
                    return False, p
                err_new_prev = err_new
            # failed factorization or no decrease: more damping — only a
            # factor beyond the cap is fatal
            hessian_factor *= 10.0
            if (term_crit.max_hessian_factor is not None
                    and hessian_factor > term_crit.max_hessian_factor):
                ba.stop_reason = "hessian overflow"
                return False, p
        ba.iterations += 1
        count("ba.iterations")
        if err_thresh is not None and abs(err_new - err_value) < err_thresh:
            ba.stop_reason = "small relative err change"
            return True, p
        err_value = err_new
        hessian_factor /= 10.0
    ba.stop_reason = "max iterations"
    return True, p


@dataclass
class BundleAdjustment:
    unity_comp_ind: int = 1
    t1y: float = 1.0
    optimize_intrinsics: bool = True
    pin_frames: tuple = ()      # fixed-keyframe BA: these poses never move
    device_loop: bool = False   # one packed fetch per trial (lm_device)
    stop_reason: str = field(default="", init=False)
    iterations: int = field(default=0, init=False)
    trials: int = field(default=0, init=False)   # damped solves incl. rejected

    def _fns(self):
        kw = dict(unity_comp_ind=self.unity_comp_ind,
                  optimize_intrinsics=self.optimize_intrinsics,
                  pin_frames=tuple(int(f) for f in self.pin_frames))
        blocks_fn = functools.partial(derivs.compute_blocks, **kw)
        solve_fn = lambda _p, blocks, factor: schur.solve_corrections_schur(  # noqa: E731
            blocks, factor, **kw)
        return blocks_fn, solve_fn, derivs.apply_corrections, reproj_error

    def compute_inplace(self, p: BAProblem,
                        term_crit: TermCriteria | None = None
                        ) -> tuple[bool, BAProblem]:
        """Full pipeline: normalize gauge, optimize, revert. Returns
        (converged, optimized problem in the original gauge)."""
        term_crit = term_crit or TermCriteria()
        if self.device_loop:
            return _run_device_loop(self, p, term_crit, *self._fns(),
                                    gauge=(self.t1y, self.unity_comp_ind))
        if not normalize.can_normalize(p, self.unity_comp_ind):
            self.stop_reason = "cannot normalize (zero cam0-cam1 shift)"
            return False, p
        p_norm, ns = normalize.normalize_scene(
            p, t1y=self.t1y, unity_comp_ind=self.unity_comp_ind)
        ok, p_opt = self.compute_on_normalized_world(p_norm, term_crit)
        return ok, normalize.revert_normalization(p_opt, ns)

    def compute_batched(self, p: BAProblem,
                        term_crit: TermCriteria | None = None
                        ) -> lm_device.BatchedLM:
        """B dense problems at once (every field of ``p`` with a leading
        batch axis, as ``interop.stack`` makes them) through the program of
        the device loop's :meth:`compute_inplace`: the gauge check,
        normalize, the LM (:func:`lm_device.run_lm_on_device_batched`, one
        packed fetch a trial for all B) and the revert, each mapped over
        the batch. A problem with a degenerate gauge comes back untouched
        with STOP_CANNOT_NORMALIZE; the others take the path they take
        alone. Returns the LM's per-problem result, its problems in the
        original gauge and its errors those of the normalized problems, as
        the single-problem loop reports them."""
        term_crit = term_crit or TermCriteria()
        blocks_fn, solve_fn, apply_fn, err_fn = self._fns()

        def lm(q, valid):
            return lm_device.run_lm_on_device_batched(
                q, blocks_fn=blocks_fn, solve_fn=solve_fn, apply_fn=apply_fn,
                err_fn=err_fn, valid=valid, **_lm_limits(term_crit))
        return lm_device.BatchedLM(*_in_gauge(p, lm, self.t1y,
                                              self.unity_comp_ind, True))

    def compute_on_normalized_world(self, p: BAProblem,
                                    term_crit: TermCriteria
                                    ) -> tuple[bool, BAProblem]:
        loop = _run_device_loop if self.device_loop else _host_loop
        return loop(self, p, term_crit, *self._fns())


@dataclass
class SparseBundleAdjustment:
    """LM over the padded-track sparse problem (models/ba/sparse.py)
    with the same damping schedule/termination as :class:`BundleAdjustment`.
    With ``group`` (a process group, ``parallel.landmark_group``) the Schur
    solve is point-sharded over its ranks (``parallel/sharded_schur``; with
    ``band`` each rank's block banded by ``sparse.plan_bands_sharded``,
    recorded as ``_mesh_band_plan``): every rank runs this LM on the same
    problem and takes the same steps. The group form keeps the host loop
    (the device loop maps its solve under vmap, which a collective does not
    take)."""

    unity_comp_ind: int = 1
    optimize_intrinsics: bool = True
    point_chunk: int = 2048
    group: object = None         # process group -> distributed solve
    pin_frames: tuple = ()       # fixed-keyframe BA
    device_loop: bool = False    # one packed fetch per trial (lm_device)
    band: bool = True            # banded Schur reduction when the
                                 # observation graph is frame-local
                                 # (sparse.plan_bands; auto-fallback)
    stop_reason: str = field(default="", init=False)
    iterations: int = field(default=0, init=False)
    trials: int = field(default=0, init=False)   # damped solves incl. rejected

    def __post_init__(self):
        if self.group is not None and self.device_loop:
            raise ValueError("the distributed solve runs in the host loop: "
                             "device_loop must be False with a group")
        self._plan_inputs = None
        self._planned_fi = None
        self._plan = None
        self._band_ext = None
        self._mesh_band_plan = None
        self._sharded = None

    def set_plan_inputs(self, frame_idx, obs_mask) -> None:
        """Host-side numpy (frame_idx, obs_mask) for the banding plan, so
        planning fetches nothing from the card. Callers that build the
        problem from host data should hand the originals over."""
        self._plan_inputs = (np.asarray(frame_idx), np.asarray(obs_mask))

    def _plan_src(self, p):
        fi_om = self._plan_inputs
        if fi_om is not None and fi_om[0].shape == tuple(p.frame_idx.shape):
            return fi_om
        return p.frame_idx.cpu().numpy(), p.obs_mask.cpu().numpy()

    def _plan_band(self, p):
        """Host-side banding plan (None: the full-width solver), kept while
        the problem's observation structure (its ``frame_idx`` tensor) is
        the same object. The JAX package also keys its compiled solver on
        the band geometry; nothing is compiled here."""
        if p.frame_idx is self._planned_fi:
            return
        self._planned_fi = p.frame_idx
        plan = None
        if self.group is not None:
            from surikatoko_tpu_torch.parallel.sharded_schur import (
                make_sharded_sparse_schur_solver)
            if self.band:
                fi_plan, om_plan = self._plan_src(p)
                plan = sp.plan_bands_sharded(
                    fi_plan, om_plan, dist.get_world_size(self.group),
                    self.point_chunk, p.n_frames)
            self._mesh_band_plan = plan
            self._sharded = make_sharded_sparse_schur_solver(
                p.n_points, p.n_frames, p.track_len, self.group,
                self.unity_comp_ind, self.optimize_intrinsics,
                self.point_chunk, tuple(int(f) for f in self.pin_frames),
                band_plan=plan)
            return
        if self.band:
            fi_plan, om_plan = self._plan_src(p)
            plan = sp.plan_bands(fi_plan, om_plan, self.point_chunk,
                                 p.n_frames)
        self._plan = plan
        self._band_ext = (None if plan is None else
                          torch.as_tensor(plan.ext_idx, device=p.points.device))

    def _solve(self, p, blocks, factor):
        kw = dict(unity_comp_ind=self.unity_comp_ind,
                  optimize_intrinsics=self.optimize_intrinsics,
                  pin_frames=tuple(int(f) for f in self.pin_frames))
        self._plan_band(p)
        if self._sharded is not None:
            return self._sharded(p, blocks, factor)
        if self._plan is not None:
            return sp.solve_corrections_schur_banded(
                p, blocks, factor, self._plan, ext_idx=self._band_ext, **kw)
        return sp.solve_corrections_schur_sparse(
            p, blocks, factor, point_chunk=self.point_chunk, **kw)

    def _fns(self):
        blocks_fn = functools.partial(
            sp.compute_blocks, unity_comp_ind=self.unity_comp_ind,
            optimize_intrinsics=self.optimize_intrinsics,
            pin_frames=tuple(int(f) for f in self.pin_frames))
        return blocks_fn, self._solve, sp.apply_corrections, sp.reproj_error

    def compute_inplace(self, p, term_crit: TermCriteria | None = None):
        """Full pipeline mirroring :meth:`BundleAdjustment.compute_inplace`:
        normalize gauge, optimize, revert (reference SceneNormalizer,
        bundle-adj-kanatani.cpp:123)."""
        term_crit = term_crit or TermCriteria()
        with span("ba.build"):
            self._plan_band(p)
        if self.device_loop:
            return _run_device_loop(self, p, term_crit, *self._fns(),
                                    gauge=(1.0, self.unity_comp_ind))
        if not normalize.can_normalize(p, self.unity_comp_ind):
            self.stop_reason = "cannot normalize (zero cam0-cam1 shift)"
            return False, p
        p_norm, ns = normalize.normalize_scene(
            p, unity_comp_ind=self.unity_comp_ind)
        ok, p_opt = self.compute(p_norm, term_crit)
        return ok, normalize.revert_normalization(p_opt, ns)

    def compute(self, p, term_crit: TermCriteria | None = None):
        term_crit = term_crit or TermCriteria()
        with span("ba.build"):
            self._plan_band(p)
        loop = _run_device_loop if self.device_loop else _host_loop
        return loop(self, p, term_crit, *self._fns())
