"""Traffic kind: the churned image-sequence loop, one frame a call, closed
loop, in the JAX bench's regime (bench.py:186-254).

``make_imageseq_scan_runner(params, recruit=True)`` with the
configuration's "runner" settings, after ``init_imageseq`` at frame 0.
Set-up warms frames 1 to "warmup_frames" (the harness's warm-up steps),
into the regime where the delete-unobserved policy and recruitment turn
slots over. The window then runs the next "replay_frames" frames, and
again from the warmed state and templates as often as the window holds
them; a restart is no frame, and its time stays in the window. A step is
one runner call for one frame, then one read of the camera position, the
frame's health (innovation Cholesky info, state finite) and its matched,
recruited and active counts.

Compared with the plain float64 reference (``reference/image.py``), each
from the program's own state and templates before it: the bootstrap, and
the sampled frames (render, search, delete, detect, recruit, update,
predict): x, P and the bookkeeping (``lib/cell.state_errs``: the matched
set through the unobserved counters, the recruited slots through the
generations, the active mask).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.lib import program, wide_world, work
from benchmark.lib.cell import lower_precision, state_errs, worst, worst_finite


class Sample(NamedTuple):
    f: int
    pre: object           # the state before the frame
    templates: object     # the templates before the frame
    post: object          # the state after it


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        from surikatoko_tpu_torch.models.monoslam import init_state
        from surikatoko_tpu_torch.world import device_runner as dr
        self.cfg, self.device, self.spans = cfg, torch.device(device), spans
        self.K = K = cfg["capacity"]
        self.rc = rc = cfg["runner"]
        self.dtype = dtype = program.dtype_of(cfg)
        self.world = wide_world.build(cfg, seed)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.sc = dr.ImageSeqDeviceScenario(
            gt_cfw_R=t(self.world.gt_cfw_R), gt_cfw_t=t(self.world.gt_cfw_t),
            gt_points=t(self.world.points), background=t(self.world.background),
            splat_amp=t(self.world.splat_amp),
            splat_sigma=t(self.world.splat_sigma))
        params = program.params(cfg, dtype, self.device)
        self.run = dr.make_imageseq_scan_runner(
            params, templ_width=rc["templ_width"],
            search_radius=rc["search_radius"],
            min_corr_coeff=rc["min_corr_coeff"], chi2_gate=rc["chi2_gate"],
            subpixel=rc["subpixel"], recruit=True,
            recruit_max=rc["recruit_max"],
            detector_corners=rc["detector_corners"],
            detector_quality=rc["detector_quality"],
            detector_nms_radius=rc["detector_nms_radius"],
            recruit_min_dist=rc["recruit_min_dist"],
            recruit_depth=rc["recruit_depth"])
        self.state, self.templates = dr.init_imageseq(
            params, self.sc, init_state(K, dtype=dtype, device=self.device),
            rc["templ_width"])
        self.init = self.state
        self.first = 1 + traffic["warmup_frames"]
        self.last = self.first + traffic["replay_frames"] - 1
        if self.last >= len(self.world.gt_cfw_R):
            raise ValueError(f"frames up to {self.last}, the path has "
                             f"{len(self.world.gt_cfw_R)}")
        self.f = 1
        self.warm = None
        self.counts = None      # (matched, recruited, active) of the last frame
        self.samples = []
        self._capture = False
        T, R = rc["templ_width"], rc["search_radius"]
        self.work = {"b1": dict(K=K, P=2 * R + T, T=T),
                     "b2": dict(B=1, D=13 + 6 * K, m=2 * K),
                     "frame_fma": work.frame_fma(K)}

    def capture_next(self) -> None:
        self._capture = True

    def step(self) -> tuple[int, int]:
        if self.f > self.last:
            self.f = self.first
            self.state, self.templates = self.warm
        if self.f == self.first and self.warm is None:
            self.warm = (self.state, self.templates)
        f = self.f
        with self.spans("loop"):
            st, tm, (_, n, cam_pos, n_rec, n_act, info) = self.run(
                self.state, self.templates, self.sc, [f])
        with self.spans("pose_read"):
            fin = torch.isfinite(st.x).all() & torch.isfinite(st.P).all()
            host = torch.cat([cam_pos.reshape(-1).to(self.dtype)]
                             + [v.reshape(-1).to(self.dtype)
                                for v in (info, fin, n, n_rec, n_act)]).cpu()
        failed = int(bool(host[3] != 0) or bool(host[4] == 0))
        self.counts = tuple(int(v) for v in host[5:8])
        if self._capture:
            self.samples.append(Sample(f, self.state, self.templates, st))
            self._capture = False
        self.state, self.templates = st, tm
        self.f += 1
        return 1, failed

    def release(self) -> None:
        self.state = self.templates = self.warm = self.run = None

    def _ref(self, dtype):
        from benchmark.reference import image, steps
        w = image.world_tensors(self.world, dtype, self.device)
        return image, steps, w, steps.params_of(self.cfg, dtype, self.device)

    def _judge(self, step_of, start: bool = True) -> list:
        """Readings of the start (the reference's bootstrap against the
        program's) and of every sampled frame, the program's post state
        (``step_of``'s) against the float64 reference's step from its pre
        state and templates: one dict a judged step."""
        image, steps, w, rp = self._ref(torch.float64)
        out = []
        if start:
            st0, _ = image.init_imageseq(rp, w, self.K, self.rc["templ_width"])
            out.append(state_errs(self.init, st0))
        for s in self.samples:
            ref, _ = image.image_step(
                rp, w, steps.state_as(s.pre, torch.float64),
                s.templates.to(torch.float64), s.f, self.rc)
            out.append(state_errs(step_of(s), ref))
        return out

    def check(self) -> dict:
        return worst(self._judge(lambda s: s.post))

    def control(self) -> dict:
        """The reference in the program's place, one precision lower."""
        dt, low = lower_precision(self.cfg)
        image, steps, w, rp = self._ref(dt)

        def step_of(s):
            with low():
                return image.image_step(rp, w, steps.state_as(s.pre, dt),
                                        s.templates.to(dt), s.f, self.rc)[0]
        return worst_finite(self._judge(step_of, start=False))
