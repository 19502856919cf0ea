"""Build the port's objects from the JAX package's, given as numpy arrays.

The tests fill both packages from the same numbers: they convert a JAX
object's leaves with ``np.asarray`` and hand it here. Matching is by field
name, so this module imports nothing of JAX or ``surikatoko_tpu``. The
carriers keep whatever leading batch axis the arrays have; :func:`stack`
makes a batch of the port's objects. Each
carrier puts its tensors on the card unless ``device`` says otherwise, and
keeps the arrays' dtypes (float64 from JAX's x64 mode).
"""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch.geom.camera import CameraIntrinsics, MikhailDistortion
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.models.ba.problem import BAProblem
from surikatoko_tpu_torch.models.ba.sparse import BAProblemSparse
from surikatoko_tpu_torch.models.monoslam.state import MonoSlamParams, MonoSlamState
from surikatoko_tpu_torch.models.mvf.factorizer import MultiViewFactorizer, TrackStore
from surikatoko_tpu_torch.vision.place_recognition import TrackDescriptors
from surikatoko_tpu_torch.world.device_runner import (
    DeviceScenario,
    ImageSeqDeviceScenario,
)


def stack(objs):
    """Objects of one NamedTuple type (problems, states, scenarios) as one
    whose every tensor field has a leading batch axis, the form that the
    batched entry points take (``run_lm_on_device_batched``,
    ``BundleAdjustment.compute_batched``, ``make_batched_scan_runner``'s
    state)."""
    return type(objs[0])(*(torch.stack(fs) for fs in zip(*objs)))


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _fields(cls, obj, device):
    return cls(**{f: _t(getattr(obj, f), device) for f in cls._fields})


def params_from_numpy(p, device: torch.device | str = "cuda") -> MonoSlamParams:
    """MonoSlamParams from an object with the JAX params' field names."""
    opt = lambda v: None if v is None else _t(v, device)
    return MonoSlamParams(
        cam=_fields(CameraIntrinsics, p.cam, device),
        dist=_fields(MikhailDistortion, p.dist, device),
        enable_distortion=bool(p.enable_distortion),
        dt=_t(p.dt, device),
        process_noise_cov=_t(p.process_noise_cov, device),
        measurm_noise_var=_t(p.measurm_noise_var, device),
        sal_pnt_init_inv_dist=_t(p.sal_pnt_init_inv_dist, device),
        sal_pnt_init_inv_dist_std=_t(p.sal_pnt_init_inv_dist_std, device),
        sal_pnt_negative_inv_rho_substitute=_t(
            p.sal_pnt_negative_inv_rho_substitute, device),
        max_undetected_frames=_t(p.max_undetected_frames, device, torch.int32),
        sal_pnt_repres=int(p.sal_pnt_repres),
        covar_diag_inflation=opt(p.covar_diag_inflation),
        ransac_corner_max_divergence_pix=opt(
            p.ransac_corner_max_divergence_pix),
        ransac_high_innov_chi_square_thresh=opt(
            p.ransac_high_innov_chi_square_thresh))


def state_from_numpy(s, device: torch.device | str = "cuda") -> MonoSlamState:
    """MonoSlamState from an object with the JAX state's field names."""
    return MonoSlamState(
        x=_t(s.x, device), P=_t(s.P, device),
        lm_active=_t(s.lm_active, device, torch.bool),
        lm_unobserved=_t(s.lm_unobserved, device, torch.int32),
        lm_generation=_t(s.lm_generation, device, torch.int32),
        frame_ind=_t(s.frame_ind, device, torch.int32))


def scenario_from_numpy(sc, device: torch.device | str = "cuda"):
    """ImageSeqDeviceScenario (if ``sc`` has a background) or
    DeviceScenario from an object with the JAX scenario's field names."""
    cls = (ImageSeqDeviceScenario if hasattr(sc, "background")
           else DeviceScenario)
    return _fields(cls, sc, device)


def se3_from_numpy(T, device: torch.device | str = "cuda") -> SE3:
    """SE3 (batched or not) from an object with R and t, e.g. the GT camera
    poses a JAX scenario hands to ``run_scenario``."""
    return _fields(SE3, T, device)


def templates_from_numpy(t, device: torch.device | str = "cuda") -> torch.Tensor:
    """[K,T,T] templates."""
    return _t(t, device)


def matcher_store_from_numpy(m, matcher):
    """Fill ``matcher``'s host template store (``templates``,
    ``templ_valid``, ``last_center``) from an object with those numpy
    arrays, e.g. a JAX ``ImageTemplCornersMatcher``, so that both matchers
    search from the same state. The store stays on the host, as in both
    packages; returns ``matcher``."""
    matcher.templates = np.array(m.templates, np.float32)
    matcher.templ_valid = np.array(m.templ_valid, bool)
    matcher.last_center = np.array(m.last_center, np.float32)
    return matcher


# the factorizer's settings that both packages have (all but K, which is
# copied, and the JAX package's ba_mesh)
_MVF_SETTINGS = (
    "ba_trigger_reproj_err", "ba_term_rel_change", "ba_max_iters",
    "refine_localization", "refine_mapping", "min_parallax_ratio",
    "fake_localization", "fake_mapping", "gt_cfw_fun", "gt_point_fun",
    "use_sparse_ba", "sparse_ba_threshold", "ba_point_chunk",
    "ba_point_bucket", "ba_frame_bucket", "ba_device_loop")


def mvf_from_numpy(m, device: torch.device | str = "cuda",
                   dtype: torch.dtype | None = None) -> MultiViewFactorizer:
    """MultiViewFactorizer carrying the state of ``m``, an object with the
    JAX factorizer's field names (e.g. a JAX ``MultiViewFactorizer`` mid-run):
    its settings, camera poses, map, BA-refined set and counters, and a copy
    of its ``TrackStore`` arrays. Both factorizers then go on from one
    state. The port's factorizer does its device work on ``device`` (the
    card unless the caller says otherwise) in ``dtype`` (default
    ``config.default_dtype(device)``); its state stays on the host, as in
    the JAX package. The JAX package's ``ba_mesh`` is not carried."""
    ts_in = m.track_store
    ts = TrackStore(ts_in.coords.shape[0], ts_in.max_frames, ts_in.L)
    for name in ("coords", "pixels", "fidx", "count"):
        setattr(ts, name, np.array(getattr(ts_in, name)))
    ts.n_tracks = int(ts_in.n_tracks)
    ts._frame_tracks = {int(f): [int(t) for t in tids]
                        for f, tids in ts_in._frame_tracks.items()}
    out = MultiViewFactorizer(
        track_store=ts, K=np.array(m.K, float), device=device, dtype=dtype,
        **{k: getattr(m, k) for k in _MVF_SETTINGS})
    out.cam_cfw_R = [np.array(R) for R in m.cam_cfw_R]
    out.cam_cfw_t = [np.array(t) for t in m.cam_cfw_t]
    out.point_coords = {int(k): np.array(v) for k, v in m.point_coords.items()}
    out._ba_points = {int(t) for t in m._ba_points}
    out.ba_runs = int(m.ba_runs)
    out.last_ba_sparse = bool(m.last_ba_sparse)
    out.last_closure_inliers = int(m.last_closure_inliers)
    return out


def descriptor_words(words, device: torch.device | str = "cuda"
                     ) -> torch.Tensor:
    """The port's int32 descriptor words from the JAX package's uint32
    words (the same bit patterns)."""
    return torch.as_tensor(np.array(words, np.uint32).view(np.int32),
                           device=device)


def track_descriptors_from_numpy(td, device: torch.device | str = "cuda"
                                 ) -> TrackDescriptors:
    """TrackDescriptors from an object with the JAX ``TrackDescriptors``'
    fields (uint32 words in, int32 words out)."""
    return TrackDescriptors(np.array(td.tids, np.int64),
                            descriptor_words(td.desc, device),
                            np.array(td.count, np.int64))


def ba_problem_from_numpy(p, device: torch.device | str = "cuda") -> BAProblem:
    """BAProblem from an object with the JAX BA problem's field names."""
    out = _fields(BAProblem, p, device)
    return out._replace(obs_mask=out.obs_mask.to(torch.bool))


def sparse_problem_from_numpy(p, device: torch.device | str = "cuda"
                              ) -> BAProblemSparse:
    """BAProblemSparse from an object with the JAX sparse BA problem's field
    names; frame_idx becomes int64."""
    out = _fields(BAProblemSparse, p, device)
    return out._replace(obs_mask=out.obs_mask.to(torch.bool),
                        frame_idx=out.frame_idx.to(torch.int64))
