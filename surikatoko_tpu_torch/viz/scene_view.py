"""3D scene visualization: cameras, landmarks, uncertainty ellipsoids,
trajectory.

Port of ``surikatoko_tpu/viz/scene_view.py``: the matplotlib equivalent of
the reference's Pangolin scene window (SceneVisualizationPangolinGui,
demo-davison-mono-slam-ui.h:77): camera frustums along the trajectory, the
landmark cloud and 3-sigma uncertainty ellipsoids, rendered after the run;
the live per-frame viewer is viz/live_view.py. matplotlib is imported
when a figure is made.
"""

from __future__ import annotations

import numpy as np

from surikatoko_tpu_torch.geom.ellipse import RotatedEllipsoid3D
from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.io.checkpoint import _host as np_


def _frustum_lines(wfc_R, wfc_t, scale=0.1):
    """Line segments of a camera frustum for a world-from-camera pose."""
    corners = np.array([
        [-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5], [-1, 0.75, 1.5],
    ]) * scale
    apex = np.zeros(3)
    pts = np.concatenate([[apex], corners]) @ np_(wfc_R).T + np_(wfc_t)
    segs = []
    for k in range(4):
        segs.append((pts[0], pts[k + 1]))
        segs.append((pts[k + 1], pts[(k + 1) % 4 + 1]))
    return segs


def _ellipsoid_wire(e: RotatedEllipsoid3D, n=12):
    u = np.linspace(0, 2 * np.pi, n)
    v = np.linspace(0, np.pi, n)
    x = np.outer(np.cos(u), np.sin(v))
    y = np.outer(np.sin(u), np.sin(v))
    z = np.outer(np.ones_like(u), np.cos(v))
    sphere = np.stack([x, y, z], axis=-1)
    pts = sphere * np_(e.semi_axes)
    return pts @ np_(e.R).T + np_(e.center)


def draw_scene(
    cam_cfw: SE3 | None = None,           # batched poses [F]
    points=None,                          # [N,3]
    ellipsoids: list[RotatedEllipsoid3D] | None = None,
    gt_cam_cfw: SE3 | None = None,
    out_path: str | None = None,
    show: bool = False,
    title: str = "surikatoko-tpu scene",
):
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")

    def draw_traj(cfw: SE3, color, label):
        R_all, t_all = np_(cfw.R), np_(cfw.t)
        F = t_all.shape[0]
        centers = []
        for f in range(F):
            wfc_R = R_all[f].T
            wfc_t = -wfc_R @ t_all[f]
            centers.append(wfc_t)
            if f % max(F // 12, 1) == 0:
                for a, b in _frustum_lines(wfc_R, wfc_t):
                    ax.plot(*zip(a, b), color=color, lw=0.5, alpha=0.6)
        centers = np.stack(centers)
        ax.plot(centers[:, 0], centers[:, 1], centers[:, 2],
                color=color, lw=1.2, label=label)

    if cam_cfw is not None:
        draw_traj(cam_cfw, "tab:blue", "estimated")
    if gt_cam_cfw is not None:
        draw_traj(gt_cam_cfw, "tab:green", "ground truth")
    if points is not None and len(points):
        pts = np_(points)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=6, c="tab:red",
                   depthshade=False, label="landmarks")
    for e in ellipsoids or []:
        w = _ellipsoid_wire(e)
        ax.plot_wireframe(w[..., 0], w[..., 1], w[..., 2],
                          color="tab:orange", lw=0.3, alpha=0.5)
    ax.set_title(title)
    ax.legend(loc="upper right")
    if out_path:
        fig.savefig(out_path, dpi=110)
    if show:
        plt.show()
    plt.close(fig)
    return out_path
