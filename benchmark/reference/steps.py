"""The plain reference of one frame of each traffic kind, from a given
state: the GT-matcher scan frame and the host-driven tracker's frame (the
demo matcher, ``_process_frame``).

Copied from the port's ``world/device_runner`` frame bodies,
``world/demo_matcher`` and ``world/runner``, over the frozen modules beside
this file.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import camera as cam_mod
from . import filter as filter_mod
from . import fused_step as fused_mod
from . import landmarks as lm_mod
from . import predict as predict_mod
from . import quat
from .state import MonoSlamParams, MonoSlamState, init_state, make_params


class WorldT(NamedTuple):
    gt_cfw_R: torch.Tensor    # [F,3,3]
    gt_cfw_t: torch.Tensor    # [F,3]
    points: torch.Tensor      # [N,3]
    image_size: torch.Tensor  # [2]


def world_tensors(world, cfg: dict, dtype, device) -> WorldT:
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return WorldT(t(world.gt_cfw_R), t(world.gt_cfw_t), t(world.points),
                  t([float(v) for v in world.image_size]))


def params_of(cfg: dict, dtype, device) -> MonoSlamParams:
    c, f = cfg["camera"], cfg["filter"]
    cam = cam_mod.make_intrinsics(c["image_size"], c["principal_point"],
                                  c["focal_length_mm"], c["pixel_size_mm"],
                                  dtype=dtype, device=device)
    return make_params(cam, None, dtype=dtype, device=device, **f)


def state_as(st: MonoSlamState, dtype) -> MonoSlamState:
    return st._replace(x=st.x.to(dtype), P=st.P.to(dtype))


# ---- GT matcher (scan runner) ----------------------------------------------

def project_gt(params: MonoSlamParams, w: WorldT, f: int, noise: torch.Tensor):
    """(pixels [N,2] of the GT points at frame ``f`` plus ``noise``,
    visible [N]) (device_runner._project_gt)."""
    xc = w.points @ w.gt_cfw_R[f].T + w.gt_cfw_t[f]
    pix = cam_mod.project_camera_point(params.cam, None, xc) + noise
    W, H = w.image_size[0], w.image_size[1]
    vis = ((xc[:, 2] > 1e-6) & (pix[:, 0] >= 0) & (pix[:, 0] < W)
           & (pix[:, 1] >= 0) & (pix[:, 1] < H)
           & torch.isfinite(pix).all(dim=-1))
    return pix, vis


def init_gt(params: MonoSlamParams, w: WorldT, K: int, noise: torch.Tensor,
            noise_std: float) -> MonoSlamState:
    """Every GT point visible at frame 0 becomes the landmark of its slot
    with GT inverse depth, then one predict (init_with_gt_landmarks)."""
    dtype, dev = w.points.dtype, w.points.device
    pix, vis = project_gt(params, w, 0, noise_std * noise.to(dtype))
    xc0 = w.points @ w.gt_cfw_R[0].T + w.gt_cfw_t[0]
    rho = 1.0 / torch.clamp(torch.linalg.norm(xc0, dim=-1), min=1e-9)
    st = init_state(K, dtype=dtype, device=dev)
    st, _ = lm_mod.add_landmarks(params, st, pix, vis, rho)
    return predict_mod.predict(params, st)


def gt_step(params: MonoSlamParams, w: WorldT, st: MonoSlamState, f: int,
            noise: torch.Tensor, noise_std: float) -> MonoSlamState:
    """One frame of the GT-matcher loop with the fused update (impl 1)."""
    obs, vis = project_gt(params, w, f, noise_std * noise.to(st.x.dtype))
    x, P, _, _, _ = fused_mod.fused_update_health_predict(
        params, st.x, st.P, obs, vis & st.lm_active)
    return st._replace(x=x, P=P)


# ---- host-driven tracker (demo matcher + process_frame) ---------------------

class MatcherBook(NamedTuple):
    """The demo matcher's state before a frame: its generator's state and
    the slot <-> fragment bookkeeping."""
    rng_state: dict
    slot_to_frag: np.ndarray
    frag_to_slot: np.ndarray


def init_from_gt(w: WorldT, K: int, dt: float) -> MonoSlamState:
    """The first camera anchors the tracker frame; GT initial linear and
    angular velocity from the first two poses (runner.
    init_tracker_state_from_gt, scene_gen.initial_camera_motion)."""
    R = w.gt_cfw_R[:2].double().cpu()
    t = w.gt_cfw_t[:2].double().cpu()
    wfc_t = [-R[i].T @ t[i] for i in range(2)]
    vel = (R[0] @ (wfc_t[1] - wfc_t[0])) / dt
    rel = R[0] @ R[1].T              # a_from_b(cfw0, cfw1).R
    ang = quat.to_axis_angle(quat.from_rotmat(rel)) / dt
    return init_state(K, cam_vel=vel.tolist(), cam_ang_vel=ang.tolist(),
                      dtype=w.points.dtype, device=w.points.device)


def demo_match(params: MonoSlamParams, w: WorldT, st: MonoSlamState, f: int,
               book: MatcherBook, mc: dict):
    """The demo matcher's two calls of frame ``f`` (match_salient_points,
    recruit_new_salient_points) from its state ``book``: (obs, obs_mask,
    new_pix, new_mask, gt_rho, frag_ids), drawing from a generator restored
    to ``book.rng_state``."""
    rng = np.random.default_rng()
    rng.bit_generator.state = book.rng_state
    dtype, dev = st.x.dtype, st.x.device
    xc = w.points @ w.gt_cfw_R[f].T + w.gt_cfw_t[f]
    pix_t = cam_mod.project_camera_point(params.cam, None, xc)
    inv_d = (1.0 / torch.clamp(torch.linalg.norm(xc, dim=-1), min=1e-12)
             ).cpu().numpy()
    pix, z = pix_t.cpu().numpy(), xc[:, 2].cpu().numpy()
    W, H = w.image_size.tolist()
    visible = ((z > 1e-6) & (pix[:, 0] >= 0) & (pix[:, 0] < W)
               & (pix[:, 1] >= 0) & (pix[:, 1] < H)
               & np.isfinite(pix).all(axis=1))
    K = st.capacity
    active = st.lm_active.cpu().numpy()
    obs, mask = np.zeros((K, 2)), np.zeros(K, bool)
    for slot in np.nonzero(active)[0]:
        frag = book.slot_to_frag[slot]
        if frag < 0 or not visible[frag]:
            continue
        obs[slot] = pix[frag] + rng.normal(scale=mc["detection_noise_std"],
                                           size=2)
        mask[slot] = True
    M = max(mc["max_new_per_frame"], mc["max_new_in_first_frame"])
    cap = mc["max_new_in_first_frame"] if f == 0 else mc["max_new_per_frame"]
    new_pix, new_mask = np.zeros((M, 2)), np.zeros(M, bool)
    gt_rho, frag_out = np.full(M, np.nan), np.full(M, -1, np.int64)
    budget = min(cap, int(np.sum(~active)))
    chosen = np.nonzero(visible & (book.frag_to_slot < 0))[0][:budget]
    gt_rho[:len(chosen)] = inv_d[chosen]
    noise = (rng.normal(scale=mc["detection_noise_std"],
                        size=(len(chosen), 2)) if len(chosen) else 0.0)
    new_pix[:len(chosen)] = pix[chosen] + noise
    new_mask[:len(chosen)] = True
    frag_out[:len(chosen)] = chosen
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return (t(obs), torch.as_tensor(mask, device=dev), t(new_pix),
            torch.as_tensor(new_mask, device=dev), t(gt_rho), frag_out)


def hostloop_step(params: MonoSlamParams, w: WorldT, st: MonoSlamState,
                  f: int, book: MatcherBook, mc: dict):
    """One frame of run_scenario: match, recruit, process_frame (impl 1),
    the matcher's bookkeeping. Returns (state, slot_to_frag after)."""
    obs, mask, new_pix, new_mask, gt_rho, frags = demo_match(
        params, w, st, f, book, mc)
    st, stats = filter_mod._process_frame(params, 1, st, obs, mask, new_pix,
                                          new_mask, gt_rho)
    s2f = book.slot_to_frag.copy()
    for s, fr in zip(stats.new_slots.cpu().numpy(), frags):
        if s >= 0 and fr >= 0:
            s2f[s] = fr
    s2f[~st.lm_active.cpu().numpy()] = -1
    return st, s2f
