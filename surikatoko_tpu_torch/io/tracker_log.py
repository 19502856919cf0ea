"""Per-frame tracker observability log + JSON export.

Port of ``surikatoko_tpu/io/tracker_log.py``; it takes the port's
``FrameStats`` and state, whose tensors may live on the card (each is read
to the host where it is recorded). Equivalent of reference
``DavisonMonoSlamInternalsLogger`` (davison-mono-slam.h:367, .cpp:78-170)
and ``WriteTrackerInternalsToFile`` (demo-davison-mono-slam.cpp:896-966).
The JSON schema keeps the reference's key names (FramesCount /
AvgFrameProcessingDur / Frames[] with CurReprojErrMeas, CamState, EstimErr,
EstimErrStd, MeasResidual, ... ), so the reference's MATLAB analysis
(matlab/check_tracker_logs.m) and this repo's analysis/check_tracker_logs.py
read either implementation's output.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class FrameSlice:
    """One frame's stats (reference DavisonMonoSlamTrackerInternalsSlice,
    davison-mono-slam.h:332-355)."""

    cur_reproj_err_meas: float = 0.0
    cur_reproj_err_pred: float = 0.0
    estimated_sal_pnts: int = 0
    new_sal_pnts: int = 0
    common_sal_pnts: int = 0
    deleted_sal_pnts: int = 0
    optimal_estim_mul_err: float = 0.0   # E[x_hat x_err^T] cross-correlation
    frame_processing_dur: float = 0.0    # seconds
    cam_state: Optional[np.ndarray] = None          # [13]
    cam_state_gt: Optional[np.ndarray] = None       # [13]
    sal_pnts_uncert_median: Optional[np.ndarray] = None  # [6] median diag covar
    estim_err: Optional[np.ndarray] = None          # [13] cam_state - GT
    estim_err_std: Optional[np.ndarray] = None      # [13] sqrt(diag Pcam)
    meas_residual: Optional[np.ndarray] = None      # [2] mean residual
    meas_residual_std: Optional[np.ndarray] = None  # [2]
    # search-efficiency telemetry (reference executed_match_templ_calls,
    # demo-davison-mono-slam.cpp:461): full-window NCC evals paid vs what an
    # ideally-gated scan would pay, and matched-by-strict-ellipse count
    templ_evals_window: Optional[int] = None
    templ_evals_gated: Optional[int] = None
    matched_in_ellipse: Optional[int] = None


class TrackerInternalsLogger:
    def __init__(self):
        self.slices: list[FrameSlice] = []
        self._frame_start: Optional[float] = None
        self._cur: Optional[FrameSlice] = None

    # reference StartNewFrameStats / RecordFrameFinishTime
    def start_new_frame(self) -> FrameSlice:
        self._cur = FrameSlice()
        self._frame_start = time.perf_counter()
        return self._cur

    def finish_frame(self) -> None:
        assert self._cur is not None
        self._cur.frame_processing_dur = time.perf_counter() - self._frame_start
        self.slices.append(self._cur)
        self._cur = None

    def record_gate_stats(self, gate_stats: dict) -> None:
        """Record a matcher's per-frame gate telemetry
        (ImageTemplCornersMatcher.last_gate_stats)."""
        s = self._cur
        assert s is not None, "call start_new_frame first"
        s.templ_evals_window = int(gate_stats.get("window_evals", 0))
        s.templ_evals_gated = int(gate_stats.get("gated_evals", 0))
        s.matched_in_ellipse = int(gate_stats.get("matched_in_ellipse", 0))

    def record_from_stats(self, stats, state=None, cam_state_gt=None) -> FrameSlice:
        """Populate the current slice from a FrameStats (and optional full
        state for uncertainty medians / GT for estimation error)."""
        s = self._cur
        assert s is not None, "call start_new_frame first"
        s.cur_reproj_err_meas = float(stats.meas_reproj_err)
        s.cur_reproj_err_pred = float(stats.opt_reproj_err)
        s.estimated_sal_pnts = int(stats.estimated_count)
        s.new_sal_pnts = int(stats.new_count)
        s.common_sal_pnts = int(stats.obs_count)
        s.deleted_sal_pnts = int(stats.deleted_count)
        s.cam_state = _host(stats.cam_state)
        s.estim_err_std = np.sqrt(np.maximum(
            np.diag(_host(stats.cam_pos_cov)), 0.0)) if stats.cam_pos_cov is not None else None
        if cam_state_gt is not None:
            s.cam_state_gt = _host(cam_state_gt)
            s.estim_err = s.cam_state - s.cam_state_gt
            # optimality cross-correlation E[x_hat * x_err^T] ~ 0 for an
            # optimal filter (reference davison-mono-slam.cpp:1804)
            s.optimal_estim_mul_err = float(np.mean(s.cam_state * s.estim_err))
        if state is not None:
            P = _host(state.P)
            act = _host(state.lm_active)
            if act.any():
                diags = []
                for k in np.nonzero(act)[0]:
                    off = 13 + 6 * k
                    diags.append(np.diag(P[off:off + 6, off:off + 6]))
                s.sal_pnts_uncert_median = np.median(np.stack(diags), axis=0)
        return s

    def avg_frame_processing_dur(self) -> float:
        if not self.slices:
            return 0.0
        return float(np.mean([s.frame_processing_dur for s in self.slices]))

    def ate_rmse(self) -> Optional[float]:
        """Similarity-aligned trajectory ATE RMSE (the BASELINE accuracy
        metric) from the recorded per-frame camera positions vs GT
        (slices need cam_state_gt; reference logs the raw per-frame error
        instead, davison-mono-slam.cpp:1781-1807)."""
        pairs = [(s.cam_state[:3], s.cam_state_gt[:3]) for s in self.slices
                 if s.cam_state is not None and s.cam_state_gt is not None]
        if len(pairs) < 3:
            return None
        from surikatoko_tpu_torch.geom.align import aligned_rmse
        est = torch.as_tensor(np.stack([p[0] for p in pairs]), dtype=torch.float64)
        gt = torch.as_tensor(np.stack([p[1] for p in pairs]), dtype=torch.float64)
        return float(aligned_rmse(est, gt))

    def write_json(self, path: str) -> None:
        def arr(x):
            return None if x is None else [float(v) for v in np.asarray(x).ravel()]

        frames = []
        for s in self.slices:
            d = {
                "CurReprojErrMeas": s.cur_reproj_err_meas,
                "CurReprojErrPred": s.cur_reproj_err_pred,
                "EstimatedSalPnts": s.estimated_sal_pnts,
                "NewSalPnts": s.new_sal_pnts,
                "CommonSalPnts": s.common_sal_pnts,
                "DeletedSalPnts": s.deleted_sal_pnts,
                "OptimalEstimMulErr": s.optimal_estim_mul_err,
                "FrameProcessingDur": s.frame_processing_dur,
                "CamState": arr(s.cam_state),
            }
            if s.templ_evals_window is not None:
                d["TemplEvalsWindow"] = s.templ_evals_window
                d["TemplEvalsGated"] = s.templ_evals_gated
                d["MatchedInEllipse"] = s.matched_in_ellipse
            for key, val in (("CamStateGT", s.cam_state_gt),
                             ("SalPntUncMedian_s", s.sal_pnts_uncert_median),
                             ("EstimErr", s.estim_err),
                             ("EstimErrStd", s.estim_err_std),
                             ("MeasResidual", s.meas_residual),
                             ("MeasResidualStd", s.meas_residual_std)):
                if val is not None:
                    d[key] = arr(val)
            frames.append(d)

        doc = {
            "FramesCount": len(self.slices),
            "AvgFrameProcessingDur": self.avg_frame_processing_dur(),
            "AteRmse": self.ate_rmse(),
            "Frames": frames,
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)


def read_tracker_internals(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
