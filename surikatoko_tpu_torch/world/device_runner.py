"""The on-device closed loops: scenario03 with the ground-truth projection
matcher (``make_scan_runner``), and the image sequence, render ->
ellipse-gated NCC search (CUDA kernel) -> delete-unobserved -> Shi-Tomasi
recruitment -> fused EKF congruence (``make_imageseq_scan_runner``), each
with the reference's four update strategies.

Port of ``surikatoko_tpu/world/device_runner.py``. JAX runs the frames as
one ``lax.scan``; here the scan is a Python loop over frames whose body keeps
the reference's fixed shapes and masks (no ``.item()``, no ``nonzero()``, no
data-dependent shapes, the frame index a device tensor), so it never waits
for the card. A one-frame call of any of these runners on a card replays
a CUDA graph of the whole frame (:class:`_FrameGraph`, by the rules of
``utils/cuda_graph``): the ~400 launches of a GT-matcher frame, the ~1000
of an image frame, become one. Scenario
data come from numpy ``default_rng(seed)`` exactly as in the reference.
The loops draw no random numbers: the GT matcher's detection noise is
passed in as standard-normal draws (JAX draws them from a key), so both
packages can be fed the same noise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom import camera as cam_mod
from surikatoko_tpu_torch.models.monoslam import fused_step as fused_mod
from surikatoko_tpu_torch.models.monoslam import health as health_mod
from surikatoko_tpu_torch.models.monoslam import landmarks as lm_mod
from surikatoko_tpu_torch.models.monoslam import measure
from surikatoko_tpu_torch.models.monoslam import predict as predict_mod
from surikatoko_tpu_torch.models.monoslam import update as update_mod
from surikatoko_tpu_torch.models.monoslam.fused_step import scatter_drop
from surikatoko_tpu_torch.models.monoslam.state import (
    REPRES_XYZ,
    MonoSlamParams,
    MonoSlamState,
)
from surikatoko_tpu_torch.ops.ncc import ncc_search
from surikatoko_tpu_torch.utils import cuda_graph
from surikatoko_tpu_torch.utils.profiling import span
from surikatoko_tpu_torch.vision import features
from surikatoko_tpu_torch.world import scene_gen
from surikatoko_tpu_torch.world.runner import gt_poses_in_tracker_frame


class DeviceScenario(NamedTuple):
    gt_cfw_R: torch.Tensor    # [F,3,3] GT camera-from-tracker
    gt_cfw_t: torch.Tensor    # [F,3]
    gt_points: torch.Tensor   # [N,3] tracker-frame world points
    image_size: torch.Tensor  # [2]
    noise_std: torch.Tensor   # detection noise


class ImageSeqDeviceScenario(NamedTuple):
    """Image-sequence scenario: frames are rendered on the device."""
    gt_cfw_R: torch.Tensor    # [F,3,3]
    gt_cfw_t: torch.Tensor    # [F,3]
    gt_points: torch.Tensor   # [N,3] tracker-frame
    background: torch.Tensor  # [H,W] static texture
    splat_amp: torch.Tensor   # blob peak intensity
    splat_sigma: torch.Tensor  # blob gaussian sigma (pixels)


def build_oscillating_scenario(capacity: int = 32,
                               dtype: torch.dtype | None = None,
                               detection_noise_std: float = 0.5,
                               max_deviation: float = 0.6,
                               world: str = "grid",
                               world_halfwidth: float = 2.4, seed: int = 0,
                               device: torch.device | str = "cuda"
                               ) -> DeviceScenario:
    """Scenario03-style world sized to ``capacity`` points: "grid" is the
    reference grid replicated and jittered up to ``capacity``; "wide" is
    ``capacity`` distinct points over a strip wider than the field of view,
    so the lateral sweep carries points in and out of view. Built on the
    host, returned on ``device`` (the card by default) in ``dtype``
    (default ``config.default_dtype(device)``)."""
    dtype = dtype or config.default_dtype(device)
    wb = scene_gen.WorldBounds(0.0, 0.9, 0.0, 0.9, 0.0, 0.9001)
    grid_pts = scene_gen.generate_grid_points(wb, (0.3, 0.3, 0.3), 0.2).numpy()
    center = grid_pts.mean(axis=0)
    if world == "wide":
        rng0 = np.random.default_rng(seed)
        points_world = np.stack([
            rng0.uniform(center[0] - world_halfwidth,
                         center[0] + world_halfwidth, capacity),
            rng0.uniform(0.0, 0.9, capacity),       # depth spread
            rng0.uniform(0.0, 0.9001, capacity),    # vertical (fully in FOV)
        ], axis=1)
    else:
        points_world = grid_pts
    gt_cfw_world = scene_gen.oscillate_right_and_left(
        center + np.array([0, -2.0, 0]), center, (0, 0, 1),
        max_deviation=max_deviation, periods_count=2, shots_per_period=160,
        const_view_dir=True)
    gt_cfw = gt_poses_in_tracker_frame(gt_cfw_world)
    R0, t0 = gt_cfw_world.R[0].numpy(), gt_cfw_world.t[0].numpy()
    pts = points_world @ R0.T + t0
    n = len(pts)
    if n < capacity:
        pts = np.concatenate([pts] * (capacity // n + 1))[:capacity]
        pts = pts + np.random.default_rng(0).normal(scale=0.02, size=pts.shape)
    else:
        pts = pts[:capacity]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return DeviceScenario(gt_cfw_R=t(gt_cfw.R), gt_cfw_t=t(gt_cfw.t),
                          gt_points=t(pts), image_size=t([320.0, 240.0]),
                          noise_std=t(detection_noise_std))


def build_imageseq_scenario(capacity: int = 96,
                            dtype: torch.dtype | None = None,
                            image_size=(320, 240), splat_amp: float = 170.0,
                            splat_sigma: float = 1.8, seed: int = 0,
                            n_points: int | None = None,
                            bg_cell: int | None = None,
                            max_deviation: float = 0.6, world: str = "grid",
                            device: torch.device | str = "cuda"
                            ) -> ImageSeqDeviceScenario:
    """Image-sequence scenario over the oscillating world. ``n_points``
    decouples the splat count from the filter capacity; ``bg_cell`` makes
    the background a bilinearly upsampled low-frequency field (cell size in
    pixels) instead of per-pixel noise. On the card unless ``device`` says
    otherwise; ``dtype`` defaults to ``config.default_dtype(device)``."""
    dtype = dtype or config.default_dtype(device)
    base = build_oscillating_scenario(capacity=n_points or capacity,
                                      dtype=dtype, max_deviation=max_deviation,
                                      world=world, device=device)
    W, H = image_size
    rng = np.random.default_rng(seed)
    if bg_cell is None:
        bg = rng.uniform(20.0, 60.0, size=(H, W)).astype(np.float32)
    else:
        gh, gw = H // bg_cell + 2, W // bg_cell + 2
        g = rng.uniform(20.0, 60.0, (gh, gw))
        ys = np.arange(H) / bg_cell
        xs = np.arange(W) / bg_cell
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        bg = (g[y0][:, x0] * (1 - fy) * (1 - fx)
              + g[y0][:, x0 + 1] * (1 - fy) * fx
              + g[y0 + 1][:, x0] * fy * (1 - fx)
              + g[y0 + 1][:, x0 + 1] * fy * fx).astype(np.float32)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return ImageSeqDeviceScenario(
        gt_cfw_R=base.gt_cfw_R, gt_cfw_t=base.gt_cfw_t,
        gt_points=base.gt_points, background=t(bg),
        splat_amp=t(splat_amp), splat_sigma=t(splat_sigma))


def _frame_index(f: int, device: torch.device) -> torch.Tensor:
    """Frame ``f`` as :func:`_project_gt` takes it: a one-element int64
    tensor, filled on the device (no copy from the host)."""
    return torch.full((1,), int(f), dtype=torch.int64, device=device)


def _project_gt(params: MonoSlamParams, sc: DeviceScenario, f: torch.Tensor,
                noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GT matcher: (pixels [K,2] of the GT points at frame ``f`` plus
    ``noise`` (already scaled), visible [K]: in front of the camera, inside
    the image and finite). ``f`` is a one-element int64 tensor on the
    scenario's device (:func:`_frame_index`), read on the device, so that a
    CUDA graph of the frame takes its frame from a buffer."""
    with span("frame.match"):
        R = sc.gt_cfw_R.index_select(0, f)[0]
        t = sc.gt_cfw_t.index_select(0, f)[0]
        xc = sc.gt_points @ R.T + t
        dist = params.dist if params.enable_distortion else None
        pix = cam_mod.project_camera_point(params.cam, dist, xc) + noise
        w, h = sc.image_size[0], sc.image_size[1]
        vis = ((xc[:, 2] > 1e-6) & (pix[:, 0] >= 0) & (pix[:, 0] < w)
               & (pix[:, 1] >= 0) & (pix[:, 1] < h)
               & torch.isfinite(pix).all(dim=-1))
    return pix, vis


def init_with_gt_landmarks(params: MonoSlamParams, sc: DeviceScenario,
                           state: MonoSlamState, noise: torch.Tensor
                           ) -> MonoSlamState:
    """Bootstrap: every GT point visible at frame 0 becomes a landmark with
    GT inverse depth (slot k <-> point k), then one predict. ``noise`` is
    standard-normal [K,2] detection noise, scaled by ``sc.noise_std``."""
    pix, vis = _project_gt(params, sc, _frame_index(0, noise.device),
                           sc.noise_std * noise)
    xc0 = sc.gt_points @ sc.gt_cfw_R[0].T + sc.gt_cfw_t[0]
    rho = 1.0 / torch.clamp(torch.linalg.norm(xc0, dim=-1), min=1e-9)
    state, _ = lm_mod.add_landmarks(params, state, pix, vis, rho)
    return predict_mod.predict(params, state)


def _sequential_update(params: MonoSlamParams, update_impl: int,
                       state: MonoSlamState, obs: torch.Tensor,
                       obs_mask: torch.Tensor):
    """Update impls 2-4 (reference davison-mono-slam.cpp:900-915), then the
    nonnegative-variance clamp, the inverse-depth substitution (spherical
    only), and the quaternion renorm fused with the predict. Returns (state,
    residual [K,2], post-update x, Cholesky info: RANSAC's stacked updates',
    0 for impls 2 and 3, which invert 2x2 / 1x1 blocks)."""
    info = torch.zeros((), dtype=torch.int32, device=obs.device)
    if update_impl == 2:
        x, P, resid = update_mod.one_obs_update(
            params, state.x, state.P, obs, obs_mask)
    elif update_impl == 3:
        x, P, resid = update_mod.one_component_update(
            params, state.x, state.P, obs, obs_mask)
    else:
        x, P, resid, _, _, info = update_mod.one_point_ransac_update(
            params, state.x, state.P, obs, obs_mask)
    P = health_mod.ensure_nonneg_variance(P)
    if params.sal_pnt_repres != REPRES_XYZ:
        x, _ = health_mod.substitute_negative_inv_rho(
            x, params.sal_pnt_negative_inv_rho_substitute, state.capacity)
    state = predict_mod.normalize_and_predict(params,
                                              state._replace(x=x, P=P))
    return state, resid, x, info


def _check_update_impl(update_impl: int) -> None:
    if update_impl not in (1, 2, 3, 4):
        raise ValueError(f"unknown update_impl {update_impl}")


class _FrameGraph:
    """One key's graph of a runner's one-frame call (``utils/cuda_graph``,
    named ``frame``) and the static buffers it reads: the tensors the frame
    carries, as a flat tuple (the scan runners: the state's six tensors and
    the noise draw; the image loop: the state's six tensors and the
    templates), and the frame index; the scenario is read in place and held
    here, so that the pointers the graph reads live. A call copies the
    caller's carried tensors into the buffers (device to device), fills the
    index, replays ``frame`` over the one frame, and returns clones of the
    graph's flat outputs, so nothing returned is overwritten by a later
    replay and nothing the caller passed is written; all of it inside the
    span ``frame``."""

    def __init__(self, frame, carried: tuple, sc):
        fresh = lambda t: torch.empty_like(
            t, memory_format=torch.contiguous_format)
        self.frame, self.sc = frame, sc
        self.carried = tuple(fresh(t) for t in carried)
        self.f = torch.zeros(1, dtype=torch.int64, device=carried[0].device)
        self.graph = cuda_graph.Graph("frame", self.f.device)

    def _work(self):
        return self.frame(self.carried, self.sc, [self.f])

    def __call__(self, carried: tuple, f: int) -> tuple:
        with span("frame"):
            for dst, src in zip(self.carried, carried):
                dst.copy_(src)
            self.f.fill_(f)
            return tuple(t.clone() for t in self.graph(self._work))


def _graphed(frame):
    """run(carried, sc, frames) over the eager loop ``frame(carried, sc,
    frame_indices)``, which takes the carried tensors as a flat tuple and
    returns its outputs as one: a one-frame call whose tensors engage a
    graph (``cuda_graph.graphable``) replays the :class:`_FrameGraph` of its
    key (the shapes of the carried tensors, the scenario tensors'
    identity); any other call runs ``frame`` as it is, over the frames as
    index tensors (:func:`_frame_index`). Only the latest key's graph is
    kept."""
    graphs = cuda_graph.Store()

    def make(carried, sc):
        graphs.clear()      # the old graph first: its pool is free to reuse
        return _FrameGraph(frame, carried, sc)

    def run(carried: tuple, sc, frames) -> tuple:
        frames = [int(f) for f in frames]
        if len(frames) == 1 and cuda_graph.graphable((*carried, *sc)):
            g = graphs.get(cuda_graph.key(carried, sc),
                           lambda: make(carried, sc))
            return g(carried, frames[0])
        dev = sc.gt_points.device
        return frame(carried, sc, [_frame_index(f, dev) for f in frames])

    return run


_NS = len(MonoSlamState._fields)


def _state_noise_runner(loop):
    """run(state, sc, frames, noise) -> (state, *outputs) of the GT-matcher
    ``loop(state, sc, frames, noise)``, carried through :func:`_graphed` as
    the state's tensors and the noise."""
    def frame(carried, sc, frames):
        st, *out = loop(MonoSlamState(*carried[:_NS]), sc, frames,
                        carried[_NS])
        return (*st, *out)

    graphed = _graphed(frame)

    def run(state: MonoSlamState, sc: DeviceScenario, frames,
            noise: torch.Tensor):
        out = graphed((*state, noise), sc, frames)
        return (MonoSlamState(*out[:_NS]), *out[_NS:])

    return run


def _scan_loop(params: MonoSlamParams, update_impl: int):
    """The GT-matcher closed loop, run(state, sc, frames, noise), over
    ``frames`` given as one-element frame index tensors
    (:func:`_frame_index`); see :func:`make_scan_runner`."""
    _check_update_impl(update_impl)

    def frame_body(sc: DeviceScenario, state: MonoSlamState, f: torch.Tensor,
                   noise: torch.Tensor):
        obs, vis = _project_gt(params, sc, f, noise)
        obs_mask = vis & state.lm_active
        if update_impl == 1:
            x_next, P_next, resid, x_upd, info = (
                fused_mod.fused_update_health_predict(
                    params, state.x, state.P, obs, obs_mask))
            state = state._replace(x=x_next, P=P_next)
        else:
            state, resid, x_upd, info = _sequential_update(
                params, update_impl, state, obs, obs_mask)
        n = obs_mask.sum()
        err = torch.linalg.norm(resid, dim=-1).sum() / torch.clamp(n, min=1)
        return state, (err, n, x_upd[:3], info)

    def run(state: MonoSlamState, sc: DeviceScenario, frames: list,
            noise: torch.Tensor):
        noise = sc.noise_std * noise
        outs = []
        for t, f in enumerate(frames):
            with span("frame"):
                state, out = frame_body(sc, state, f, noise[t])
            outs.append(out)
        return (state, *(torch.stack(o) for o in zip(*outs)))

    return run


def make_scan_runner(params: MonoSlamParams, update_impl: int = 1):
    """Scenario03 closed loop with the GT projection matcher: project the GT
    points, gate by the image, add detection noise, update with
    ``update_impl`` (1 = the fused congruence; 2-4 as in
    :func:`_sequential_update`), predict.

    Returns run(state, sc, frames, noise) -> (state, errs [T], n_matched
    [T], cam_pos [T,3] after each update, chol_info [T]), with ``noise``
    standard-normal [T,K,2], scaled by ``sc.noise_std`` inside (JAX draws it
    from a key). ``chol_info`` is the innovation Cholesky's info per frame
    (0 = factorized): the fused step's for impl 1, the stacked updates' for
    impl 4, zeros for impls 2 and 3. A one-frame call on a card replays a
    CUDA graph of the frame (:func:`_graphed`, ``utils/cuda_graph``); the
    returned tensors are the caller's own either way."""
    return _state_noise_runner(_scan_loop(params, update_impl))


def make_batched_scan_runner(params: MonoSlamParams, update_impl: int = 1):
    """B instances of :func:`make_scan_runner`'s closed loop, one per noise
    draw, run as one batch, as the JAX package vmaps its run over noise keys
    (tests/test_batch_eval.py). Built with ``torch.func.vmap`` over the
    unbatched loop: every op of a frame runs once for the batch, and kernel
    B2 (the fused step's downdate, impl 1; the stacked updates', impl 4)
    launches once a frame for all instances. A one-frame call on a card
    replays a CUDA graph of the whole vmapped frame (:func:`_graphed`,
    ``utils/cuda_graph``: vmap runs inside the capture).

    Returns run(state, sc, frames, noise) -> (state, errs [B,T], n_matched
    [B,T], cam_pos [B,T,3], chol_info [B,T]): ``noise`` [B,T,K,2] is each
    instance's standard-normal draws; ``state`` is shared by every instance
    (x [D]) or carries a leading B (x [B,D]); the returned state carries a
    leading B. Each instance equals its own unbatched run up to the rounding
    of batched matrix products."""
    loop = _scan_loop(params, update_impl)

    def body(state: MonoSlamState, sc: DeviceScenario, frames: list,
             noise: torch.Tensor):
        return torch.func.vmap(
            lambda st, nz: loop(st, sc, frames, nz),
            in_dims=(0 if state.x.dim() == 2 else None, 0))(state, noise)

    return _state_noise_runner(body)


def render_frame(params: MonoSlamParams, sc: ImageSeqDeviceScenario,
                 f: int | torch.Tensor) -> torch.Tensor:
    """One [H,W] frame: static background + a gaussian blob at every visible
    GT point's projection. The separable splat sum is one [H,K] @ [K,W]
    matmul. ``f`` is a frame number or, as :func:`_project_gt` takes it, a
    one-element int64 tensor on the scenario's device, read on the device,
    so that a CUDA graph of the frame takes its frame from a buffer."""
    with span("frame.render"):
        H, W = sc.background.shape
        dtype, dev = sc.background.dtype, sc.background.device
        if not isinstance(f, torch.Tensor):
            f = _frame_index(f, dev)
        R = sc.gt_cfw_R.index_select(0, f)[0]
        t = sc.gt_cfw_t.index_select(0, f)[0]
        xc = sc.gt_points @ R.T + t
        dist = params.dist if params.enable_distortion else None
        pix = cam_mod.project_camera_point(params.cam, dist, xc)
        finite = torch.isfinite(pix)
        vis = (xc[:, 2] > 1e-6) & finite.all(dim=-1)
        pix = torch.where(finite, pix, -1e6)
        inv2s2 = 1.0 / (2.0 * sc.splat_sigma * sc.splat_sigma)
        xs = torch.arange(W, dtype=dtype, device=dev)
        ys = torch.arange(H, dtype=dtype, device=dev)
        ex = torch.exp(-(xs[None, :] - pix[:, 0:1]) ** 2 * inv2s2)    # [K,W]
        ey = torch.exp(-(ys[None, :] - pix[:, 1:2]) ** 2 * inv2s2)    # [K,H]
        a = sc.splat_amp * vis.to(dtype)
        img = sc.background + (ey * a[:, None]).T @ ex
        return torch.clamp(img, 0.0, 255.0)


def _gather_templates(image: torch.Tensor, centers: torch.Tensor, T: int
                      ) -> torch.Tensor:
    """[K,T,T] patches centered at (rounded, clamped) pixel centers."""
    H, W = image.shape
    ci = torch.round(centers).to(torch.int32) - (T - 1) // 2
    ar = torch.arange(T, device=image.device)
    y = torch.clamp(ci[:, 1], 0, H - T)[:, None] + ar
    x = torch.clamp(ci[:, 0], 0, W - T)[:, None] + ar
    return image[y[:, :, None], x[:, None, :]]


def init_imageseq(params: MonoSlamParams, sc: ImageSeqDeviceScenario,
                  state: MonoSlamState, templ_width: int,
                  max_bootstrap: int | None = None
                  ) -> tuple[MonoSlamState, torch.Tensor]:
    """Bootstrap from the rendered frame 0: claim the visible GT points (GT
    inverse depth, at most ``max_bootstrap``) and cut each one's template
    from the image, scattered by assigned slot."""
    img0 = render_frame(params, sc, 0)
    xc0 = sc.gt_points @ sc.gt_cfw_R[0].T + sc.gt_cfw_t[0]
    dist = params.dist if params.enable_distortion else None
    pix = cam_mod.project_camera_point(params.cam, dist, xc0)
    H, W = img0.shape
    vis = ((xc0[:, 2] > 1e-6) & (pix[:, 0] >= 0) & (pix[:, 0] < W)
           & (pix[:, 1] >= 0) & (pix[:, 1] < H))
    if max_bootstrap is not None:
        vis = vis & (torch.cumsum(vis, dim=0) <= max_bootstrap)
    rho = 1.0 / torch.clamp(torch.linalg.norm(xc0, dim=-1), min=1e-9)
    state, slots = lm_mod.add_landmarks(params, state, pix, vis, rho)
    patches = _gather_templates(img0, pix, templ_width)
    Kcap = state.capacity
    templates = torch.zeros((Kcap, templ_width, templ_width), dtype=img0.dtype,
                            device=img0.device)
    templates = scatter_drop(templates, torch.where(slots >= 0, slots, Kcap),
                             patches)
    return predict_mod.predict(params, state), templates


def make_imageseq_scan_runner(params: MonoSlamParams, *, templ_width: int = 15,
                              search_radius: int = 7,
                              min_corr_coeff: float = 0.6,
                              chi2_gate: float = 5.99146,
                              update_impl: int = 1,
                              subpixel: bool = False,
                              recruit: bool = False,
                              recruit_max: int = 8,
                              detector_corners: int = 24,
                              detector_quality: float = 0.05,
                              detector_nms_radius: int = 5,
                              recruit_min_dist: float = 14.0,
                              target_active: int | None = None,
                              recruit_depth: str = "prior"):
    """The closed loop render -> gated NCC search -> EKF update -> predict,
    with (``recruit=True``) per-frame Shi-Tomasi recruitment into freed
    slots through the fused recruit congruence and the delete-unobserved
    policy folded in. ``update_impl`` 1 is the fused congruence; 2-4 are the
    sequential and RANSAC updates of :func:`_sequential_update`, where a
    slot the delete-unobserved policy drops is only deactivated and keeps
    its rows of x and P, as in JAX. ``recruit_depth``: "prior" (flat configured prior),
    "median" (global median tracked inverse depth) or "local" (median of
    the 8 nearest tracked landmarks in pixel space). ``target_active``
    throttles recruitment to keep the active count near that number: each
    frame recruits at most target_active - active (clipped to
    [0, recruit_max]). Recruitment requires update_impl=1.

    Returns run(state, templates, sc, frames) -> with recruit: (state,
    templates, (err, n_matched, cam_pos, n_recruited, n_active,
    chol_info)); without: (state, (err, n_matched, cam_pos, chol_info));
    every output is stacked over frames. ``chol_info`` is the innovation
    Cholesky's info per frame (0 = factorized; as in
    :func:`make_scan_runner`). A one-frame call on a card replays a CUDA
    graph of the frame, search kernel, recruitment and downdate included
    (:func:`_graphed`, ``utils/cuda_graph``); it writes nothing into the
    state and templates it is given, and the returned tensors are the
    caller's own either way."""
    _check_update_impl(update_impl)
    if recruit and update_impl != 1:
        raise ValueError("on-device recruitment requires update_impl=1")
    if recruit_depth not in ("prior", "median", "local"):
        raise ValueError(f"unknown recruit_depth {recruit_depth!r}")

    def frame_body(sc: ImageSeqDeviceScenario, state: MonoSlamState,
                   templates: torch.Tensor, f: torch.Tensor):
        img = render_frame(params, sc, f)
        dtype = state.x.dtype
        Kcap = state.capacity

        with span("frame.measure"):
            # predicted pixels, A_un = H P and T_un = H P H^T: shared by the
            # search ellipse and the fused update
            h, Hcam, Hlm = measure.measurement_jacobians(params, state.x)
            # a diverged landmark's row can be non-finite while unmatched;
            # zero it before masking (0 * nan = nan), force it unmatchable
            row_ok = (torch.isfinite(h).all(dim=-1)
                      & torch.isfinite(Hcam.reshape(Kcap, -1)).all(dim=-1)
                      & torch.isfinite(Hlm.reshape(Kcap, -1)).all(dim=-1))
            h = torch.where(row_ok[:, None], h, 0.0)
            Hcam = torch.where(row_ok[:, None, None], Hcam, 0.0)
            Hlm = torch.where(row_ok[:, None, None], Hlm, 0.0)
            A_un = update_mod.hp_auto(Hcam, Hlm, state.P)
            T_un = update_mod.aht_auto(A_un, Hcam, Hlm)
            # per-slot 2x2 innovation: the diagonal 2x2 blocks of T_un + R
            S2 = (torch.diagonal(T_un.reshape(Kcap, 2, Kcap, 2), dim1=0,
                                 dim2=2).permute(2, 0, 1)
                  + params.measurm_noise_var * torch.eye(2, dtype=dtype,
                                                         device=h.device))
            det = S2[:, 0, 0] * S2[:, 1, 1] - S2[:, 0, 1] * S2[:, 1, 0]
            det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
            sigma_inv = torch.stack([
                torch.stack([S2[:, 1, 1], -S2[:, 0, 1]], -1),
                torch.stack([-S2[:, 1, 0], S2[:, 0, 0]], -1)],
                -2) / det[:, None, None]

        with span("frame.search"):
            res = ncc_search(img, h, templates, state.lm_active,
                             search_radius=search_radius,
                             min_corr_coeff=min_corr_coeff,
                             sigma_inv=sigma_inv, chi2_gate=chi2_gate,
                             subpixel=subpixel)
        obs = res.best_center
        obs_mask = res.matched & state.lm_active & row_ok

        # delete-unobserved policy (reference :799-840), folded into the
        # fused congruence
        unobs = torch.where(obs_mask, 0, state.lm_unobserved + 1)
        mu = params.max_undetected_frames
        drop = (mu > 0) & (unobs > mu) & state.lm_active
        state = state._replace(lm_unobserved=unobs,
                               lm_active=state.lm_active & ~drop)
        n = obs_mask.sum()

        if not recruit:
            if update_impl == 1:
                x_next, P_next, resid, x_upd, info = (
                    fused_mod.fused_update_health_predict(
                        params, state.x, state.P, obs, obs_mask,
                        precomputed=(h, A_un, T_un), deactivate_mask=drop))
                state = state._replace(x=x_next, P=P_next)
            else:
                state, resid, x_upd, info = _sequential_update(
                    params, update_impl, state, obs, obs_mask)
            err = torch.linalg.norm(resid, dim=-1).sum() / torch.clamp(n, min=1)
            return state, templates, (err, n, x_upd[:3], info)

        active_after = state.lm_active
        with span("frame.detect"):
            cand_xy, cand_ok = features.detect_corners(
                img, max_corners=detector_corners,
                nms_radius=detector_nms_radius, border=templ_width,
                quality_level=detector_quality)
            cur_pos = torch.where(res.matched[:, None], obs, h)
            cand_ok = features.filter_out_closest(
                cand_xy, cand_ok, cur_pos, active_after, recruit_min_dist)
            sel = torch.argsort((~cand_ok).to(torch.int32),
                                stable=True)[:recruit_max]
            new_pix = cand_xy[sel].to(dtype)
            new_valid = cand_ok[sel]
            if target_active is not None:
                budget = torch.clamp(target_active - active_after.sum(), 0,
                                     recruit_max)
                new_valid = new_valid & (torch.arange(new_valid.shape[0],
                                                      device=new_valid.device)
                                         < budget)
            if recruit_depth == "median":
                rho0 = fused_mod.median_tracked_inv_depth(params, state.x,
                                                          active_after, Kcap)
            elif recruit_depth == "local":
                rho0 = fused_mod.local_tracked_inv_depth(
                    params, state.x, active_after, Kcap, new_pix, cur_pos)
            else:
                rho0 = None
        x_next, P_next, resid, x_upd, slots, info = (
            fused_mod.fused_update_health_recruit_predict(
                params, state.x, state.P, obs, obs_mask, new_pix, new_valid,
                ~active_after, precomputed=(h, A_un, T_un),
                deactivate_mask=drop, rho0=rho0))
        slot_safe = torch.where(slots >= 0, slots, Kcap)
        claimed = scatter_drop(torch.zeros_like(active_after), slot_safe,
                               torch.ones_like(new_valid))
        active = active_after | claimed
        templates = scatter_drop(
            templates, slot_safe,
            _gather_templates(img, new_pix, templ_width).to(templates.dtype))
        state = state._replace(
            x=x_next, P=P_next, lm_active=active,
            lm_unobserved=torch.where(claimed, 0, state.lm_unobserved),
            lm_generation=state.lm_generation + claimed.to(torch.int32))
        err = torch.linalg.norm(resid, dim=-1).sum() / torch.clamp(n, min=1)
        return state, templates, (err, n, x_upd[:3], (slots >= 0).sum(),
                                  active.sum(), info)

    def frames_loop(carried, sc: ImageSeqDeviceScenario, frames):
        state, templates = MonoSlamState(*carried[:_NS]), carried[_NS]
        outs = []
        for f in frames:
            with span("frame"):
                state, templates, out = frame_body(sc, state, templates, f)
            outs.append(out)
        return (*state, templates, *(torch.stack(o) for o in zip(*outs)))

    graphed = _graphed(frames_loop)

    def run(state: MonoSlamState, templates: torch.Tensor,
            sc: ImageSeqDeviceScenario, frames):
        out = graphed((*state, templates), sc, frames)
        state, out = MonoSlamState(*out[:_NS]), out[_NS:]
        if recruit:
            return state, out[0], out[1:]
        return state, out[1:]

    return run
