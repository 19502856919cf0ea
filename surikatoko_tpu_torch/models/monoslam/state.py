"""MonoSlam state layout: fixed-capacity tensors in place of the reference's
dynamically resized state vector and covariance.

Port of ``surikatoko_tpu/models/monoslam/state.py``. Layout (reference
davison-mono-slam.h:21-36): camera x[0:13] = [r(3), q(4) wfc scalar-first,
v(3), w(3)]; landmark slot k at x[13+6k : 19+6k] = [first_cam_pos(3),
azimuth, elevation, inverse distance] (spherical) or [xyz(3), 0, 0, 0] (XYZ).
Capacity is static: K slots, D = 13 + 6K variables always; ``lm_active``
marks live slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom.camera import CameraIntrinsics, MikhailDistortion

CAM_STATE_COMPS = 13
SAL_PNT_COMPS = 6

REPRES_XYZ = 1
REPRES_SPHERICAL = 2


class MonoSlamParams(NamedTuple):
    """Filter parameters: 0-d/[n] tensors, plus two Python values that change
    which code runs (``enable_distortion``, ``sal_pnt_repres``)."""

    cam: CameraIntrinsics
    dist: MikhailDistortion
    enable_distortion: bool
    dt: torch.Tensor
    process_noise_cov: torch.Tensor          # [6,6]
    measurm_noise_var: torch.Tensor          # pixel variance
    sal_pnt_init_inv_dist: torch.Tensor
    sal_pnt_init_inv_dist_std: torch.Tensor
    sal_pnt_negative_inv_rho_substitute: torch.Tensor
    max_undetected_frames: torch.Tensor      # int32; 0 = never delete
    sal_pnt_repres: int = REPRES_SPHERICAL
    # per-frame diagonal inflation (f32 conditioning); None when off, so the
    # fused steps skip the diagonal write entirely
    covar_diag_inflation: torch.Tensor | None = None
    # 1-point RANSAC gates (reference flags monoslam_1pransac_corner_max_
    # divergence_pix / monoslam_1pransac_high_innov_chisq_thr_pix2); None
    # means the pixel noise std / 9.21034
    ransac_corner_max_divergence_pix: torch.Tensor | None = None
    ransac_high_innov_chi_square_thresh: torch.Tensor | None = None


class MonoSlamState(NamedTuple):
    x: torch.Tensor               # [D]
    P: torch.Tensor               # [D, D]
    lm_active: torch.Tensor       # [K] bool
    lm_unobserved: torch.Tensor   # [K] int32: consecutive frames unmatched
    lm_generation: torch.Tensor   # [K] int32: bumped on slot reuse
    frame_ind: torch.Tensor       # int32

    @property
    def capacity(self) -> int:
        return self.lm_active.shape[0]


def make_params(cam: CameraIntrinsics, dist: MikhailDistortion | None = None,
                *, dt: float = 1.0,
                process_noise_lin_veloc_std: float = 0.15,
                process_noise_ang_veloc_std: float = 0.01,
                measurm_noise_std_pix: float = 1.0,
                sal_pnt_init_inv_dist: float = 0.1,
                sal_pnt_init_inv_dist_std: float = 1.0,
                sal_pnt_negative_inv_rho_substitute: float = 1e-4,
                max_undetected_frames: int = 0,
                covar_diag_inflation: float = 0.0,
                sal_pnt_repres: int = REPRES_SPHERICAL,
                ransac_corner_max_divergence_pix: float | None = None,
                ransac_high_innov_chi_square_thresh: float = 9.21034,
                dtype: torch.dtype | None = None,
                device: torch.device | str = "cuda") -> MonoSlamParams:
    """On the card unless ``device`` says otherwise; ``dtype`` defaults to
    ``config.default_dtype(device)``."""
    dtype = dtype or config.default_dtype(device)
    if sal_pnt_repres not in (REPRES_XYZ, REPRES_SPHERICAL):
        raise ValueError(f"unknown sal_pnt_repres {sal_pnt_repres}")
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    q = t([process_noise_lin_veloc_std**2] * 3
          + [process_noise_ang_veloc_std**2] * 3)
    enable = dist is not None
    if dist is None:
        dist = MikhailDistortion(t(0.0), t(0.0))
    return MonoSlamParams(
        cam=cam, dist=dist, enable_distortion=enable,
        dt=t(dt),
        process_noise_cov=torch.diag(q),
        measurm_noise_var=t(measurm_noise_std_pix**2),
        sal_pnt_init_inv_dist=t(sal_pnt_init_inv_dist),
        sal_pnt_init_inv_dist_std=t(sal_pnt_init_inv_dist_std),
        sal_pnt_negative_inv_rho_substitute=t(
            sal_pnt_negative_inv_rho_substitute),
        max_undetected_frames=torch.as_tensor(
            max_undetected_frames, dtype=torch.int32, device=device),
        sal_pnt_repres=sal_pnt_repres,
        covar_diag_inflation=(None if covar_diag_inflation == 0.0
                              else t(covar_diag_inflation)),
        ransac_corner_max_divergence_pix=(
            None if ransac_corner_max_divergence_pix is None
            else t(ransac_corner_max_divergence_pix)),
        ransac_high_innov_chi_square_thresh=t(
            ransac_high_innov_chi_square_thresh),
    )


def init_state(capacity: int, *, cam_pos=(0.0, 0.0, 0.0),
               cam_quat=(1.0, 0.0, 0.0, 0.0), cam_vel=(0.0, 0.0, 0.0),
               cam_ang_vel=(0.0, 0.0, 0.0), cam_pos_std=0.0,
               cam_orient_q_comp_std=0.0, cam_vel_std=0.0,
               cam_ang_vel_std=0.0, dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda") -> MonoSlamState:
    """Camera at the tracker origin with the configured diagonal uncertainty
    (zeros by default: the first camera anchors the gauge). On the card
    unless ``device`` says otherwise; ``dtype`` defaults to
    ``config.default_dtype(device)``."""
    dtype = dtype or config.default_dtype(device)
    D = CAM_STATE_COMPS + SAL_PNT_COMPS * capacity
    x = torch.zeros(D, dtype=dtype, device=device)
    x[:CAM_STATE_COMPS] = torch.as_tensor(
        [*cam_pos, *cam_quat, *cam_vel, *cam_ang_vel], dtype=dtype)
    diag = torch.zeros(D, dtype=dtype, device=device)
    diag[:CAM_STATE_COMPS] = torch.as_tensor(
        [cam_pos_std**2] * 3 + [cam_orient_q_comp_std**2] * 4
        + [cam_vel_std**2] * 3 + [cam_ang_vel_std**2] * 3, dtype=dtype)
    zi = lambda: torch.zeros(capacity, dtype=torch.int32, device=device)
    return MonoSlamState(
        x=x, P=torch.diag(diag),
        lm_active=torch.zeros(capacity, dtype=torch.bool, device=device),
        lm_unobserved=zi(), lm_generation=zi(),
        frame_ind=torch.zeros((), dtype=torch.int32, device=device))
