"""Traffic kind: the host-driven tracker, the reference's own operating
mode, one frame a step, closed loop.

``MonoSlamFilter(params, capacity, update_impl=1)`` with a
``DemoCornersMatcher`` (detection noise, the whole capacity as the first
frame's budget, its generator seeded from the benchmark's seed), stepped
as ``world.runner.run_scenario``'s loop body: match, recruit,
``process_frame``, the matcher's slot bookkeeping, then the camera
position copied to the host. The tracker starts from the GT pose and
velocity (``init_tracker_state_from_gt``).
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from benchmark.lib import program, work
from benchmark.lib import world as world_mod
from benchmark.lib.cell import lower_precision, state_errs, worst, worst_finite


class Sample(NamedTuple):
    f: int
    pre: object
    post: object
    book: object             # the matcher's state before the frame
    slot_to_frag: np.ndarray  # after the frame


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        from surikatoko_tpu_torch.geom.se3 import SE3
        from surikatoko_tpu_torch.models.monoslam.filter import MonoSlamFilter
        from surikatoko_tpu_torch.world.demo_matcher import DemoCornersMatcher
        from surikatoko_tpu_torch.world.runner import init_tracker_state_from_gt
        self.cfg, self.traffic, self.device, self.spans = (
            cfg, traffic, torch.device(device), spans)
        self.K = K = cfg["capacity"]
        self.dtype = dtype = program.dtype_of(cfg)
        self.world = world_mod.build(cfg, seed)
        self.F = len(self.world.gt_cfw_R)
        params = program.params(cfg, dtype, self.device)
        sc = program.gt_scenario(self.world, cfg, dtype, self.device)
        self.tracker = MonoSlamFilter(params, capacity=K, update_impl=1)
        gt = SE3(sc.gt_cfw_R, sc.gt_cfw_t)
        self.mc = mc = dict(cfg["matcher"], **traffic["matcher"])
        self.matcher = DemoCornersMatcher(
            self.tracker, gt, sc.gt_points,
            image_size=tuple(cfg["camera"]["image_size"]),
            detection_noise_std=mc["detection_noise_std"],
            max_new_per_frame=mc["max_new_per_frame"],
            max_new_in_first_frame=mc["max_new_in_first_frame"],
            seed=int(np.random.SeedSequence(int(seed)).generate_state(1)[0]))
        self.state = init_tracker_state_from_gt(self.tracker, gt,
                                                dt=float(params.dt))
        self.init = self.state
        self.i = 0
        self.samples = []
        self._capture = True            # frame 0: the start
        self.work = {"b2": dict(B=1, D=13 + 6 * K, m=2 * K),
                     "frame_fma": work.frame_fma(K)}

    def capture_next(self) -> None:
        self._capture = True

    def _book(self):
        from benchmark.reference.steps import MatcherBook
        m = self.matcher
        return MatcherBook(copy.deepcopy(m.rng.bit_generator.state),
                           m.slot_to_frag.copy(), m.frag_to_slot.copy())

    def step(self) -> tuple[int, int]:
        f = self.i % self.F
        book = self._book() if self._capture else None
        m, st = self.matcher, self.state
        with self.spans("matcher"):
            obs, mask = m.match_salient_points(st, f)
            new_pix, new_mask, gt_rho, frags = m.recruit_new_salient_points(
                st, f, mask)
        with self.spans("filter"):
            st, stats = self.tracker.process_frame(st, obs, mask, new_pix,
                                                   new_mask, gt_rho)
            m.on_landmarks_added(stats.new_slots, frags, st)
            m.sync_removed(st)
        with self.spans("pose_read"):
            fin = torch.isfinite(st.x).all() & torch.isfinite(st.P).all()
            host = torch.cat([stats.cam_state[:3],
                              fin.reshape(1).to(self.dtype)]).cpu()
        if book is not None:
            self.samples.append(Sample(f, self.state, st, book,
                                       m.slot_to_frag.copy()))
            self._capture = False
        self.state = st
        self.i += 1
        return 1, int(host[3] == 0)

    def release(self) -> None:
        self.state = self.tracker = self.matcher = None

    def _judge(self, step_of, start: bool = True) -> list:
        """Each sampled frame (frame 0, the start, among them): the post
        state and the matcher's bookkeeping that ``step_of`` gives against
        the float64 reference's frame from the same pre state and matcher
        state; the start's pre state against the reference's own. One dict
        a judged step."""
        from benchmark.reference import steps
        f64 = torch.float64
        w = steps.world_tensors(self.world, self.cfg, f64, self.device)
        rp = steps.params_of(self.cfg, f64, self.device)
        out = [state_errs(self.init, steps.init_from_gt(
            w, self.K, self.cfg["filter"]["dt"]))] if start else []
        for s in self.samples:
            ref, s2f = steps.hostloop_step(rp, w, steps.state_as(s.pre, f64),
                                           s.f, s.book, self.mc)
            post, post_s2f = step_of(s)
            r = state_errs(post, ref)
            r["bookkeeping_mismatch"] += int((post_s2f != s2f).sum())
            out.append(r)
        return out

    def check(self) -> dict:
        return worst(self._judge(lambda s: (s.post, s.slot_to_frag)))

    def control(self) -> dict:
        """The reference in the program's place, one precision lower."""
        from benchmark.reference import steps
        dt, low = lower_precision(self.cfg)
        w = steps.world_tensors(self.world, self.cfg, dt, self.device)
        rp = steps.params_of(self.cfg, dt, self.device)

        def step_of(s):
            with low():
                return steps.hostloop_step(rp, w, steps.state_as(s.pre, dt),
                                           s.f, s.book, self.mc)
        return worst_finite(self._judge(step_of, start=False))
