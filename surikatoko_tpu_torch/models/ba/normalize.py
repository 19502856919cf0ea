"""Scene normalization for BA gauge freedom.

Port of ``surikatoko_tpu/models/ba/normalize.py`` (reference SceneNormalizer,
bundle-adj-kanatani.cpp:123-333): re-express the world in the first camera's
frame and scale so the cam0->cam1 shift has a unity component:
  scale = t1y / |T01[uc]|,  T01 = (cam0_from_cam1).T
  R_k' = R_k R_0^T;  T_k' = (T_k - R_k R_0^T T_0) * scale;  X' = (R_0 X + T_0) * scale
The functions touch only points/cfw_R/cfw_t, so they take the dense and the
sparse problem alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NormState(NamedTuple):
    R0: torch.Tensor         # pre-normalization cam0_from_world rotation
    T0: torch.Tensor
    world_scale: torch.Tensor
    unity_comp_ind: int


def _t01(cfw_R: torch.Tensor, cfw_t: torch.Tensor) -> torch.Tensor:
    """cam0_from_cam1 translation: SE3AFromB(cfw0, cfw1).T = T0 - R0 R1^T T1."""
    return cfw_t[0] - cfw_R[0] @ (cfw_R[1].T @ cfw_t[1])


def normalize_scene(p, t1y: float = 1.0, unity_comp_ind: int = 1,
                    min_shift: float | None = None):
    """Returns (normalized problem, NormState). ``min_shift`` (optional)
    floors |T01[uc]| so a degenerate gauge (zero cam0-cam1 shift) yields a
    finite scale instead of inf; the device loop's validity gate
    refuses that result separately (lm._run_device_loop), hosts call
    :func:`can_normalize` first."""
    R0, T0 = p.cfw_R[0], p.cfw_t[0]
    shift_abs = torch.abs(_t01(p.cfw_R, p.cfw_t)[unity_comp_ind])
    if min_shift is not None:
        shift_abs = torch.clamp(shift_abs, min=min_shift)
    scale = t1y / shift_abs

    R_new = torch.einsum("fij,kj->fik", p.cfw_R, R0)     # R_k R_0^T
    T_new = (p.cfw_t - torch.einsum("fij,j->fi", R_new, T0)) * scale
    X_new = (p.points @ R0.T + T0) * scale
    p_new = p._replace(points=X_new, cfw_R=R_new, cfw_t=T_new)
    return p_new, NormState(R0=R0, T0=T0, world_scale=scale,
                            unity_comp_ind=unity_comp_ind)


def can_normalize(p, unity_comp_ind: int = 1, atol: float = 1e-5) -> bool:
    """One device->host fetch of the 3-vector T01."""
    T01 = _t01(p.cfw_R, p.cfw_t).cpu()
    return bool(abs(float(T01[unity_comp_ind])) > atol)


def revert_normalization(p, ns: NormState):
    scale = ns.world_scale
    R_new = torch.einsum("fij,jk->fik", p.cfw_R, ns.R0)
    T_new = p.cfw_t / scale + torch.einsum("fij,j->fi", p.cfw_R, ns.T0)
    X_new = (p.points / scale - ns.T0) @ ns.R0
    return p._replace(points=X_new, cfw_R=R_new, cfw_t=T_new)


def check_world_is_normalized(p, t1y: float = 1.0, unity_comp_ind: int = 1,
                              atol: float = 1e-3) -> bool:
    """Reference CheckWorldIsNormalized (bundle-adj-kanatani.cpp:288)."""
    eye = torch.eye(3, dtype=p.cfw_R.dtype, device=p.cfw_R.device)
    eye_ok = bool(torch.all(torch.abs(p.cfw_R[0] - eye) < atol))
    t0_ok = bool(torch.linalg.norm(p.cfw_t[0]) < atol)
    # direct pose of frame1: t1_direct = -R1^T T1
    t1_direct = -p.cfw_R[1].T @ p.cfw_t[1]
    t1_ok = bool(torch.abs(torch.abs(t1_direct[unity_comp_ind]) - t1y) < atol)
    return eye_ok and t0_ok and t1_ok
