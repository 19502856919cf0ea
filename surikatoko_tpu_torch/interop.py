"""Build the port's objects from the JAX package's, given as numpy arrays.

The tests fill both packages from the same numbers: they convert a JAX
object's leaves with ``np.asarray`` and hand it here. Matching is by field
name, so this module imports nothing of JAX or ``surikatoko_tpu``. Each
carrier puts its tensors on the card unless ``device`` says otherwise, and
keeps the arrays' dtypes (float64 from JAX's x64 mode).
"""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch.geom.camera import CameraIntrinsics, MikhailDistortion
from surikatoko_tpu_torch.models.ba.problem import BAProblem
from surikatoko_tpu_torch.models.ba.sparse import BAProblemSparse
from surikatoko_tpu_torch.models.monoslam.state import MonoSlamParams, MonoSlamState
from surikatoko_tpu_torch.world.device_runner import (
    DeviceScenario,
    ImageSeqDeviceScenario,
)


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


def templates_from_numpy(t, device: torch.device | str = "cuda") -> torch.Tensor:
    """[K,T,T] templates."""
    return _t(t, device)


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
