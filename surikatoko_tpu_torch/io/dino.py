"""Oxford dinosaur dataset: loader + synthetic stand-in.

Port of ``surikatoko_tpu/io/dino.py``. The reference expects the VGG files
``dinosaur/dinoPs_as_mat108x4.txt`` (36 stacked 3x4 P-matrices) and
``dinosaur/viff.xy`` (4983 rows x 72 cols of (x,y) per frame, -1 =
unobserved). ``load_dino_problem`` reproduces the reference demo's pipeline
(demo-bundle-adj-dinosaur.cpp): decompose P -> (K, pose), f0-scale K,
triangulate each track from its observing frames, and assemble the BA
problem. ``synthetic_dino_raw`` makes a dino-scale turntable scene with the
same shapes, from the same numpy draws in the same order as the JAX package,
so both packages build the same scene from one seed.

Set-up runs on the host in float64; the loaders cast the finished problem
to ``dtype`` on ``device`` (float64 on the CPU when both are None).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from surikatoko_tpu_torch.geom import se3, triangulate
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.io.mat_io import read_matrix_from_file
from surikatoko_tpu_torch.models.ba import sparse as sp
from surikatoko_tpu_torch.models.ba.problem import BAProblem, make_problem


def _cast(p, dtype, device):
    """Floating fields to ``dtype``, every field to ``device``."""
    return type(p)(*(x.to(device=device, dtype=dtype) if x.is_floating_point()
                     else x.to(device) for x in p))


def load_dino_problem(testdata_dir: str, f0: float = 600.0,
                      max_points: int | None = None, dtype=None,
                      device=None) -> BAProblem:
    P_rows, obs, mask = _parse_dino_files(testdata_dir, max_points)
    n_frames = P_rows.shape[0] // 3
    return _cast(build_problem_from_proj_mats(
        P_rows.reshape(n_frames, 3, 4), obs, mask, f0), dtype, device)


def load_dino_problem_sparse(testdata_dir: str, f0: float = 600.0,
                             max_points: int | None = None, dtype=None,
                             device=None):
    """Same parse/decompose/triangulate path as :func:`load_dino_problem`,
    assembled as the track-major sparse problem (the real viff.xy tracks
    average ~3.6 observations over 36 frames). Returns (BAProblemSparse,
    frame_idx_host, track_mask_host); the host arrays feed
    SparseBundleAdjustment.set_plan_inputs."""
    P_rows, obs, mask = _parse_dino_files(testdata_dir, max_points)
    n_frames = P_rows.shape[0] // 3
    dense = build_problem_from_proj_mats(
        P_rows.reshape(n_frames, 3, 4), obs, mask, f0)
    obs_s, fidx, tmask = sp.dense_obs_to_tracks(obs, mask)
    p_sp = sp.BAProblemSparse(
        points=dense.points, cfw_R=dense.cfw_R, cfw_t=dense.cfw_t,
        K=dense.K, obs=torch.as_tensor(obs_s, dtype=dense.points.dtype),
        frame_idx=torch.as_tensor(fidx, dtype=torch.int64),
        obs_mask=torch.as_tensor(tmask), f0=dense.f0)
    return _cast(p_sp, dtype, device), fidx, tmask


def _parse_dino_files(testdata_dir: str, max_points: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    pdir = os.path.join(testdata_dir, "oxfvisgeom", "dinosaur")
    P_rows = read_matrix_from_file(os.path.join(pdir, "dinoPs_as_mat108x4.txt"))
    viff = read_matrix_from_file(os.path.join(pdir, "viff.xy"))
    n_frames = P_rows.shape[0] // 3
    if viff.shape[1] != 2 * n_frames:
        raise ValueError(f"viff.xy has {viff.shape[1]} columns for "
                         f"{n_frames} frames")

    obs = viff.reshape(-1, n_frames, 2)
    mask = ~np.any(obs == -1, axis=-1)
    keep = mask.sum(axis=1) >= 2          # need >=2 views to triangulate
    obs, mask = obs[keep], mask[keep]
    if max_points is not None:
        obs, mask = obs[:max_points], mask[:max_points]
    return P_rows, obs, mask


def build_problem_from_proj_mats(Ps: np.ndarray, obs: np.ndarray,
                                 mask: np.ndarray, f0: float) -> BAProblem:
    """Decompose P-matrices, f0-scale K, triangulate tracks; the reference
    demo's setup path (demo-bundle-adj-dinosaur.cpp:140-200). float64 on
    the CPU."""
    num_stab = np.diag([1.0 / f0, 1.0 / f0, 1.0])
    Ks, cfw_Rs, cfw_ts, P_f0 = [], [], [], []
    for P in np.asarray(Ps, np.float64):
        _, K, wfc = triangulate.decompose_proj_mat(torch.as_tensor(P))
        Knew = num_stab @ K.numpy()
        Knew[0, 1] = 0.0                   # zero_cam_intrinsic_mat_01
        cfw = wfc.inv()
        R, t = cfw.R.numpy(), cfw.t.numpy()
        Ks.append(Knew)
        cfw_Rs.append(R)
        cfw_ts.append(t)
        P_f0.append(Knew @ np.concatenate([R, t[:, None]], axis=1))

    points = triangulate.triangulate_points_batch(
        torch.as_tensor(np.stack(P_f0)), torch.as_tensor(np.asarray(obs, np.float64)),
        f0, torch.as_tensor(mask))
    cfw = SE3(torch.as_tensor(np.stack(cfw_Rs)), torch.as_tensor(np.stack(cfw_ts)))
    return make_problem(points, cfw, np.stack(Ks), obs, mask, f0)


def synthetic_dino_raw(n_frames: int = 36, n_points: int = 1024,
                       noise_pix: float = 0.5, visibility: float = 0.3,
                       seed: int = 0, vary_track_len: bool = False
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Raw turntable scene with dino-like statistics: (Ps [F,3,4],
    obs [N,F,2], mask [N,F], gt_points [N,3]) — the pre-file-format data.

    ``vary_track_len`` draws each track's visible arc from [2, F/3]
    (the real viff.xy's short-track distribution) instead of a fixed arc.
    """
    rng = np.random.default_rng(seed)
    # body: noisy cylinder, radius ~0.5, height 1
    ang = rng.uniform(0, 2 * np.pi, n_points)
    rad = 0.5 + rng.normal(scale=0.08, size=n_points)
    z = rng.uniform(0, 1.0, n_points)
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], axis=1)

    K = np.array([[3300.0, 0, 360.0], [0, 3300.0, 288.0], [0, 0, 1.0]])
    cam_angles = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    eye = np.stack([6.0 * np.cos(cam_angles), 6.0 * np.sin(cam_angles),
                    np.full(n_frames, 1.8)], axis=1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    wfc = se3.look_at_luf_wfc(t(eye), t(np.broadcast_to([0.0, 0, 0.5], eye.shape)),
                              t(np.broadcast_to([0.0, 0, 1.0], eye.shape)))
    # cfw = wfc^-1. numpy's summation order depends on the memory layout:
    # the translation from the transposed view and the projections below
    # from a contiguous copy reproduce the JAX build bit for bit
    R_view = wfc.R.mT.numpy()
    cfw_ts = -(R_view @ eye[:, :, None])[..., 0]
    cfw_Rs = np.ascontiguousarray(R_view)
    Ps = K @ np.concatenate([cfw_Rs, cfw_ts[:, :, None]], axis=2)

    # observations: each point seen from a contiguous arc of cameras (the
    # turntable occlusion pattern), with pixel noise
    obs = np.zeros((n_points, n_frames, 2))
    mask = np.zeros((n_points, n_frames), bool)
    arc_fixed = max(2, int(visibility * n_frames))
    for i in range(n_points):
        arc = (int(rng.integers(2, max(3, n_frames // 3)))
               if vary_track_len else arc_fixed)
        facing = np.arctan2(pts[i, 1], pts[i, 0])
        start = int((facing / (2 * np.pi)) * n_frames) % n_frames
        for k in range(arc):
            j = (start + k) % n_frames
            xc = cfw_Rs[j] @ pts[i] + cfw_ts[j]
            if xc[2] <= 0.1:
                continue
            ph = K @ xc
            obs[i, j] = ph[:2] / ph[2] + rng.normal(scale=noise_pix, size=2)
            mask[i, j] = True
    return Ps, obs, mask, pts


def synthetic_dino_problem(n_frames: int = 36, n_points: int = 1024,
                           f0: float = 600.0, noise_pix: float = 0.5,
                           visibility: float = 0.3, seed: int = 0
                           ) -> tuple[BAProblem, np.ndarray]:
    """Turntable scene with dino-like statistics. Returns (problem with
    triangulated-from-noisy-corners initialization, GT points)."""
    Ps, obs, mask, pts = synthetic_dino_raw(
        n_frames, n_points, noise_pix, visibility, seed)
    return build_problem_from_proj_mats(Ps, obs, mask, f0), pts


GT_SIDECAR = "dino_gt_points.txt"


def write_dino_files(out_dir: str, Ps: np.ndarray, obs: np.ndarray,
                     mask: np.ndarray, gt_points: np.ndarray | None = None
                     ) -> str:
    """Write a scene in the REAL VGG dino file formats so a run exercises
    the same parse path as the actual dataset
    (demo-bundle-adj-dinosaur.cpp:97-116):

    - ``dinoPs_as_mat108x4.txt``: the F projection matrices stacked to a
      [3F, 4] text matrix;
    - ``viff.xy``: [N, 2F] with (x, y) per frame and ``-1.000000`` holes
      for unobserved entries;
    - optional GT sidecar (NOT part of the real format; consumed for map-ATE
      reporting when present).

    Returns the ``oxfvisgeom/dinosaur`` directory it wrote into.
    """
    pdir = os.path.join(out_dir, "oxfvisgeom", "dinosaur")
    os.makedirs(pdir, exist_ok=True)
    n_frames = Ps.shape[0]
    with open(os.path.join(pdir, "dinoPs_as_mat108x4.txt"), "w") as f:
        for row in Ps.reshape(3 * n_frames, 4):
            f.write(" ".join(f"{v:.10e}" for v in row) + "\n")
    holes = np.where(mask[:, :, None], obs, -1.0)
    with open(os.path.join(pdir, "viff.xy"), "w") as f:
        for row in holes.reshape(-1, 2 * n_frames):
            f.write("  ".join(f"{v:.6f}" for v in row) + "\n")
    if gt_points is not None:
        with open(os.path.join(pdir, GT_SIDECAR), "w") as f:
            for row in gt_points:
                f.write(" ".join(f"{v:.10e}" for v in row) + "\n")
    return pdir


def load_gt_points(testdata_dir: str) -> np.ndarray | None:
    """GT sidecar of a synthesized scene (None for real data)."""
    path = os.path.join(testdata_dir, "oxfvisgeom", "dinosaur", GT_SIDECAR)
    if not os.path.exists(path):
        return None
    return read_matrix_from_file(path)
