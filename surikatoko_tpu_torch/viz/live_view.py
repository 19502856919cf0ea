"""Live run viewer: per-frame 3D scene + 2D camera view with hotkeys.

Reduced-scope parity with the reference's interactive UI
(SceneVisualizationPangolinGui + DavisonMonoSlam2DDrawer,
demo-davison-mono-slam-ui.h:77,:164): a matplotlib window refreshed every
frame showing the estimated trajectory, landmark cloud with 3-sigma
ellipsoids, the GT trajectory, and the 2D camera view with projected
landmarks + uncertainty ellipses. Hotkeys mirror the reference's:

  s  toggle observation suppression ("camera covered with a blanket")
  u  request full reset-to-GT on the next frame
  i  request a state dump on the next frame
  q  stop the run

Scene picking (reference mouse interaction, demo-davison-mono-slam-ui.h:77):
clicking a landmark point in the 3D pane selects its SLOT — the viewer
prints the slot id, generation, estimated position, positional sigma and
unobserved-frame count, and highlights the landmark in both panes until
another is picked (Escape clears). Headless callers can drive the same
path with :meth:`pick_slot`.

The demo loop polls the request flags (host-driven, like the reference's
worker thread polling the UI chat state, demo-davison-mono-slam-ui.h:41-51 —
except there is no second thread: pure functions need none). Falls back to
headless PNG dumps (`save_frames_dir`) when no display is available — the
equivalent of ctrl_log_slam_images_{cam0,scene3D}.

Port of ``surikatoko_tpu/viz/live_view.py``: the hooks call the port's
``health``, ``measure``, ``quat`` and ``update`` (the state may lie on the
card; what is drawn is copied to the host). One difference, by design: the
ellipses and ellipsoids are made at the configured confidence, where the
JAX file passes the chi-square quantile itself as the confidence
(live_view.py:174, :203), which makes every ring NaN, so none is drawn.
matplotlib is imported when the view is made.
"""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch.geom import ellipse as ell_mod
from surikatoko_tpu_torch.geom import quat as quat_mod
from surikatoko_tpu_torch.io.checkpoint import _host as np_
from surikatoko_tpu_torch.models.monoslam import health, measure
from surikatoko_tpu_torch.models.monoslam import update as update_mod
from surikatoko_tpu_torch.viz.scene_view import _ellipsoid_wire, _frustum_lines


class LiveMonoSlamView:
    def __init__(self, image_size=(320, 240), max_ellipsoids: int = 64,
                 save_frames_dir: str | None = None, pause: float = 0.001,
                 confidence_2d: float = 0.95, confidence_3d: float = 0.95):
        import matplotlib

        self.save_dir = save_frames_dir
        self.interactive = save_frames_dir is None
        if self.interactive:
            try:
                import matplotlib.pyplot as plt
                fig = plt.figure(figsize=(12, 5))
                fig.canvas.manager.show()
            except Exception:
                self.interactive = False
        if not self.interactive:
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig = plt.figure(figsize=(12, 5))
            if self.save_dir:
                import os
                os.makedirs(self.save_dir, exist_ok=True)
        self._plt = plt
        self.fig = fig
        self.ax3d = fig.add_subplot(121, projection="3d")
        self.ax2d = fig.add_subplot(122)
        self.image_size = image_size
        self.max_ellipsoids = max_ellipsoids
        self.pause = pause
        self.confidence_2d = confidence_2d
        self.confidence_3d = confidence_3d
        self.traj_est: list[np.ndarray] = []
        self.traj_gt: list[np.ndarray] = []
        # hotkey state the demo loop polls
        self.suppress = False
        self.want_reset = False
        self.want_dump = False
        self.want_quit = False
        # scene picking state
        self.picked_slot: int | None = None
        self._sc_artist = None
        self._pick_map = np.zeros(0, int)
        self._pick_info: dict = {}
        if self.interactive:
            fig.canvas.mpl_connect("key_press_event", self._on_key)
            fig.canvas.mpl_connect("pick_event", self._on_pick)

    def _on_key(self, ev) -> None:
        if ev.key == "s":
            self.suppress = not self.suppress
        elif ev.key == "u":
            self.want_reset = True
        elif ev.key == "i":
            self.want_dump = True
        elif ev.key == "q":
            self.want_quit = True
        elif ev.key == "escape":
            self.picked_slot = None

    def _on_pick(self, ev) -> None:
        if ev.artist is not self._sc_artist or len(ev.ind) == 0:
            return
        self.pick_slot(int(self._pick_map[int(ev.ind[0])]))

    def pick_slot(self, slot: int) -> dict:
        """Select landmark ``slot`` (what a 3D-pane click resolves to) and
        print its state line; returns the info dict. Usable headless."""
        self.picked_slot = slot
        info = self._pick_info.get(slot)
        if info is not None:
            print(f"picked lm[{slot}] gen={info['gen']} "
                  f"xyz=[{info['pos'][0]:+.3f} {info['pos'][1]:+.3f} "
                  f"{info['pos'][2]:+.3f}] sigma={info['sigma']:.4f} "
                  f"unobs={info['unobs']}", flush=True)
        return info or {}

    def update(self, params, state, frame_ind: int, *,
               obs=None, obs_mask=None, gt_wfc_t=None, image=None) -> None:
        """Redraw both panes from the current filter state (on any
        device; what is drawn is copied to the host)."""
        x = np_(state.x)
        active = np_(state.lm_active)
        self.traj_est.append(x[:3].copy())
        if gt_wfc_t is not None:
            self.traj_gt.append(np_(gt_wfc_t))

        pos, covs = health.landmark_pos_covariances(
            state.x, state.P, state.capacity,
            params.sal_pnt_negative_inv_rho_substitute, params.sal_pnt_repres)
        pos = np_(pos)
        covs = np_(covs)

        ax = self.ax3d
        # user camera orbit sticks across redraws (the reference UI's
        # orbitable 3D scene, demo-davison-mono-slam-ui.h:77): read the
        # axes' current view angles BEFORE cla clobbers them, restore after
        azim, elev = ax.azim, ax.elev
        ax.cla()
        ax.view_init(elev=elev, azim=azim)
        ax.set_title(f"frame {frame_ind}"
                     + ("  [SUPPRESSED]" if self.suppress else ""))
        tr = np.stack(self.traj_est)
        ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], color="tab:blue",
                lw=1.2, label="estimated")
        if self.traj_gt:
            tg = np.stack(self.traj_gt)
            ax.plot(tg[:, 0], tg[:, 1], tg[:, 2], color="tab:green",
                    lw=1.0, label="ground truth")
        self._pick_map = np.nonzero(active)[0]
        gen = np_(state.lm_generation)
        unobs = np_(state.lm_unobserved)
        self._pick_info = {
            int(k): dict(pos=pos[k], gen=int(gen[k]), unobs=int(unobs[k]),
                         sigma=float(np.sqrt(max(np.trace(covs[k]), 0.0))))
            for k in self._pick_map}
        if active.any():
            self._sc_artist = ax.scatter(
                pos[active, 0], pos[active, 1], pos[active, 2],
                s=6, c="tab:red", depthshade=False, picker=True,
                pickradius=4)
        if self.picked_slot is not None and active[self.picked_slot]:
            pk = pos[self.picked_slot]
            ax.scatter([pk[0]], [pk[1]], [pk[2]], s=70,
                       facecolors="none", edgecolors="tab:purple", lw=1.5)
            info = self._pick_info[int(self.picked_slot)]
            ax.text(pk[0], pk[1], pk[2],
                    f" lm[{self.picked_slot}] σ={info['sigma']:.3f}",
                    fontsize=7, color="tab:purple")
        # camera frustum at the current estimate (wfc pose from the state)
        R_wfc = np_(quat_mod.to_rotmat(torch.as_tensor(x[3:7])))
        for a, b in _frustum_lines(R_wfc, x[:3], scale=0.12):
            ax.plot(*zip(a, b), color="tab:blue", lw=0.8)
        shown = 0
        for k in np.nonzero(active)[0]:
            if shown >= self.max_ellipsoids:
                break
            cov = torch.as_tensor(covs[k])
            if not bool(ell_mod.is_ellipsoid_extractable(cov)):
                continue
            e = ell_mod.ellipsoid_from_covariance(
                cov, torch.as_tensor(pos[k]), self.confidence_3d)
            w = _ellipsoid_wire(e, n=8)
            ax.plot_wireframe(w[..., 0], w[..., 1], w[..., 2],
                              color="tab:orange", lw=0.3, alpha=0.5)
            shown += 1
        ax.legend(loc="upper right", fontsize=7)

        ax2 = self.ax2d
        ax2.cla()
        W, H = self.image_size
        ax2.set_xlim(0, W)
        ax2.set_ylim(H, 0)
        ax2.set_aspect("equal")
        ax2.set_title("camera view (2D)")
        if image is not None:
            ax2.imshow(np_(image), cmap="gray", vmin=0, vmax=255,
                       extent=(0, W, H, 0))
        # projected landmarks + per-slot 2x2 innovation ellipses
        h, Hcam, Hlm = measure.measurement_jacobians(params, state.x)
        K = state.capacity
        Hd = update_mod._dense_h(Hcam, Hlm)
        T_un = np_((Hd @ state.P @ Hd.T).reshape(K, 2, K, 2))
        h = np_(h)
        r_var = float(np_(params.measurm_noise_var))
        for k in np.nonzero(active)[0]:
            S2 = T_un[k, :, k, :] + r_var * np.eye(2)
            e = ell_mod.ellipse_from_covariance(
                torch.as_tensor(S2), torch.as_tensor(h[k]),
                self.confidence_2d)
            tt = np.linspace(0, 2 * np.pi, 24)
            circ = np.stack([np.cos(tt), np.sin(tt)], -1)
            ring = circ * np_(e.semi_axes) @ np_(e.R).T + np_(e.center)
            ax2.plot(ring[:, 0], ring[:, 1], color="tab:orange", lw=0.7)
            ax2.plot([h[k, 0]], [h[k, 1]], "+", color="tab:blue", ms=5)
        if obs is not None and obs_mask is not None:
            o = np_(obs)
            m = np_(obs_mask)
            ax2.plot(o[m, 0], o[m, 1], "x", color="tab:green", ms=5,
                     label="matched obs")
            ax2.legend(loc="upper right", fontsize=7)
        if self.picked_slot is not None and active[self.picked_slot]:
            ax2.plot([h[self.picked_slot, 0]], [h[self.picked_slot, 1]],
                     "o", ms=11, mfc="none", mec="tab:purple", mew=1.5)

        if self.interactive:
            self.fig.canvas.draw_idle()
            self._plt.pause(self.pause)
        elif self.save_dir:
            self.fig.savefig(f"{self.save_dir}/frame{frame_ind:05d}.png",
                             dpi=90)

    def close(self) -> None:
        self._plt.close(self.fig)


def save_frames(params, states_and_frames, out_dir: str, **kw) -> str:
    """Headless PNG dump of a recorded run (ctrl_log_slam_images_* parity):
    states_and_frames = iterable of (state, frame_ind [, gt_wfc_t])."""
    view = LiveMonoSlamView(save_frames_dir=out_dir, **kw)
    for item in states_and_frames:
        state, f = item[0], item[1]
        gt = item[2] if len(item) > 2 else None
        view.update(params, state, f, gt_wfc_t=gt)
    view.close()
    return out_dir
