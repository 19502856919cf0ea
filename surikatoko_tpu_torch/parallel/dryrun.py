"""Multi-rank dry run of the distribution layer at realistic shapes.

Port of ``__graft_entry__.dryrun_multichip``: on n ranks
(``launch.run_ranks``; NCCL on cards, gloo for ``device="cpu"``)

1. the landmark-sharded FUSED frame loop at capacity 768 (D = 4621; each
   rank's rows stay local over the frames, the full P gathered once);
2. the point-sharded BANDED sparse Schur BA at 2048 points x 100 frames
   (``sparse.plan_bands_sharded`` must engage);
3. the CHURNED sharded imageseq loop at K = 256 on 640x480 (distributed
   render, local NCC search, recruitment, delete-unobserved) for 6 frames,
   matching more than K/2 slots on the last one.

    python -m surikatoko_tpu_torch.parallel.dryrun [--ranks 1] [--device cuda]

Returns (and the module prints) rank 0's metrics; every rank computes the
same replicated ones.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom import camera
from surikatoko_tpu_torch.models.ba import SparseBundleAdjustment, TermCriteria
from surikatoko_tpu_torch.models.monoslam import landmarks
from surikatoko_tpu_torch.models.monoslam.state import init_state, make_params
from surikatoko_tpu_torch.parallel import launch, mesh
from surikatoko_tpu_torch.parallel import sharded_ekf as se
from surikatoko_tpu_torch.parallel.sharded_imageseq import (
    make_sharded_imageseq_runner)
from surikatoko_tpu_torch.world import device_runner as dr
from surikatoko_tpu_torch.world.ba_scene import build_at_scale_problem


def make_problem(capacity: int, device, dtype):
    """(params, state, obs, obs_mask): every slot a landmark spread over the
    320x240 image, observed with 1 px noise (``__graft_entry__``'s)."""
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype, device=device)
    params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         measurm_noise_std_pix=1.0, dtype=dtype, device=device)
    state = init_state(capacity, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    pix = t(rng.uniform((20, 20), (300, 220), size=(capacity, 2)))
    mask = torch.ones(capacity, dtype=torch.bool, device=device)
    rho = t(rng.uniform(0.4, 0.9, size=capacity))
    state, _ = landmarks.add_landmarks(params, state, pix, mask, rho)
    obs = pix + t(rng.normal(scale=1.0, size=(capacity, 2)))
    return params, state, obs, mask


# the dry run's sizes: the fused loop's capacity, the BA's (points, frames),
# the imageseq loop's slots and frames
SIZES = dict(capacity=768, ba_size=(2048, 100), img_k=256, frames_img=6)


def _body(n: int, device: str, capacity: int, ba_size: tuple, img_k: int,
          frames_img: int) -> dict:
    """Rank body of :func:`dryrun_multichip`."""
    group = mesh.landmark_group(n)
    dtype = config.default_dtype(device)
    if device != "cpu":
        config.set_full_precision()
    out = {"ranks": n, "device": device}

    # 1. the sharded fused frame loop
    capacity += (-capacity) % n
    params, state, obs, obs_mask = make_problem(capacity, device, dtype)
    t0 = time.perf_counter()
    x, P, costs = se.make_sharded_fused_loop(params, capacity, group)(
        state.x, state.P, obs.expand(2, *obs.shape), obs_mask)
    ok = bool(torch.isfinite(x).all() and torch.isfinite(costs).all())
    if not (ok and torch.equal(P, P.T)):
        raise AssertionError("sharded fused loop: non-finite or P != P^T")
    out["fused"] = {"capacity": capacity, "D": int(x.shape[0]), "frames": 2,
                    "s": time.perf_counter() - t0}

    # 2. the distributed banded sparse Schur BA
    n_pts, n_frames = ba_size
    ps, fidx, fmask = build_at_scale_problem(n_pts, n_frames, 12,
                                             noise_pix=0.3, seed=0,
                                             dtype=dtype, device=device)
    ba = SparseBundleAdjustment(group=group, point_chunk=64, band=True)
    ba.set_plan_inputs(fidx, fmask)
    t0 = time.perf_counter()
    ok, ps_opt = ba.compute(ps, TermCriteria(allowed_reproj_err_rel_change=None,
                                             max_iters=2))
    plan = ba._mesh_band_plan
    if not ok or plan is None:
        raise AssertionError(f"sharded banded BA: ok {ok}, plan {plan is not None}")
    out["ba"] = {"points": n_pts, "frames": n_frames, "iterations":
                 ba.iterations, "band_width": plan.band_width,
                 "banded_chunks": plan.n_banded_chunks,
                 "point_chunk": plan.point_chunk,
                 "s": time.perf_counter() - t0}

    # 3. the churned sharded imageseq loop
    K = img_k + (-img_k) % n
    n_world = K + K // 4
    n_world += (-n_world) % n
    sc = dr.build_imageseq_scenario(capacity=K, dtype=dtype, n_points=n_world,
                                    bg_cell=48, max_deviation=0.8,
                                    world="wide", image_size=(640, 480),
                                    device=device)
    cam = camera.make_intrinsics((640, 480), (320.0, 240.0), 1.95,
                                 (0.005, 0.005), dtype=dtype, device=device)
    t = lambda v, dt=dtype: torch.as_tensor(v, dtype=dt, device=device)
    params_img = params._replace(cam=cam, sal_pnt_init_inv_dist=t(0.5),
                                 sal_pnt_init_inv_dist_std=t(0.5),
                                 max_undetected_frames=t(4, torch.int32))
    st = init_state(K, dtype=dtype, device=device)
    st, templates = dr.init_imageseq(params_img, sc, st, 15,
                                     max_bootstrap=K - K // 8)
    run = make_sharded_imageseq_runner(params_img, K, group, templ_width=15,
                                       recruit=True, recruit_max=8,
                                       detector_corners=48)
    t0 = time.perf_counter()
    *_, (err, n_m, _, n_rec, n_act, _) = run(
        st.x, st.P, templates, st.lm_active, st.lm_unobserved,
        st.lm_generation, sc, range(1, 1 + frames_img))
    if not bool(torch.isfinite(err).all()):
        raise AssertionError("sharded imageseq diverged")
    if int(n_m[-1]) <= K // 2 or int(n_rec.sum()) < 1:
        raise AssertionError(f"sharded imageseq: {int(n_m[-1])}/{K} matched, "
                             f"{int(n_rec.sum())} recruited")
    out["imageseq"] = {"K": K, "frames": frames_img,
                       "matched_last": int(n_m[-1]),
                       "recruited": int(n_rec.sum()),
                       "active_last": int(n_act[-1]),
                       "s": time.perf_counter() - t0}
    return out


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda",
                     **sizes) -> dict:
    """The dry run on ``n_devices`` new ranks (one card each on "cuda");
    returns rank 0's metrics. ``sizes`` replace some of :data:`SIZES` (they
    shrink for a CPU rehearsal)."""
    device = torch.device(device).type
    outs = launch.run_ranks(_body, n_devices, n_devices, device,
                            device=device, **{**SIZES, **sizes})
    return outs[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(dryrun_multichip(args.ranks, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
