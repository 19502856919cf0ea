"""Traffic kind: the GT-matcher scan runner, one frame a call, closed loop.

``make_scan_runner(params, 1)`` (traffic "batch" 0) or, over "batch"
instances that each draw their own detection noise,
``make_batched_scan_runner(params, 1)``, after ``init_with_gt_landmarks``.
A step is one runner call for one frame, then the camera positions and the
frame's health (innovation Cholesky info, state finite) copied to the host.
The standard-normal detection noise comes from the seed, made on the
device in one call and used in turn (frame i takes draw i mod
"noise_frames").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.lib import program, work
from benchmark.lib import world as world_mod
from benchmark.lib.cell import lower_precision, state_errs, worst, worst_finite


class Sample(NamedTuple):
    f: int
    i: int
    pre: object
    post: object


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        from surikatoko_tpu_torch.models.monoslam import init_state
        from surikatoko_tpu_torch.world import device_runner as dr
        self.cfg, self.traffic, self.device, self.spans = (
            cfg, traffic, torch.device(device), spans)
        self.K = K = cfg["capacity"]
        self.B = B = traffic.get("batch", 0)
        self.dtype = dtype = program.dtype_of(cfg)
        self.world = world_mod.build(cfg, seed)
        self.F = len(self.world.gt_cfw_R)
        self.L = traffic["noise_frames"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(world_mod.torch_seed(seed))
        self.init_noise = torch.randn((K, 2), generator=gen, dtype=dtype,
                                      device=self.device)
        self.noise = torch.randn(((B,) if B else ()) + (self.L, K, 2),
                                 generator=gen, dtype=dtype,
                                 device=self.device)
        params = program.params(cfg, dtype, self.device)
        self.sc = program.gt_scenario(self.world, cfg, dtype, self.device)
        self.state = dr.init_with_gt_landmarks(
            params, self.sc, init_state(K, dtype=dtype, device=self.device),
            self.init_noise)
        self.init = self.state
        self.run = (dr.make_batched_scan_runner(params, 1) if B
                    else dr.make_scan_runner(params, 1))
        self.i = 1
        self.samples = []
        self._capture = False
        D = 13 + 6 * K
        self.work = {"b2": dict(B=max(B, 1), D=D, m=2 * K),
                     "frame_fma": work.frame_fma(K, max(B, 1))}

    def capture_next(self) -> None:
        self._capture = True

    def step(self) -> tuple[int, int]:
        i, f = self.i, self.i % self.F
        j = i % self.L
        nz = self.noise[:, j:j + 1] if self.B else self.noise[j:j + 1]
        with self.spans("loop"):
            st, _, _, cam_pos, info = self.run(self.state, self.sc, [f], nz)
        with self.spans("pose_read"):
            fin = (torch.isfinite(st.x).all(dim=-1)
                   & torch.isfinite(st.P).flatten(-2).all(dim=-1))
            n = max(self.B, 1)
            host = torch.cat([cam_pos.reshape(-1), info.reshape(-1).to(self.dtype),
                              fin.reshape(-1).to(self.dtype)]).cpu()
        failed = int(((host[3 * n:4 * n] != 0) | (host[4 * n:] == 0)).sum())
        if self._capture:
            self.samples.append(Sample(f, i, self.state, st))
            self._capture = False
        self.state = st
        self.i += 1
        return n, failed

    def release(self) -> None:
        self.state = self.run = None

    def _ref(self, dtype):
        from benchmark.reference import steps
        w = steps.world_tensors(self.world, self.cfg, dtype, self.device)
        return steps, w, steps.params_of(self.cfg, dtype, self.device)

    def _instances(self, st):
        """The instances of a (possibly batched) state, one state each."""
        if not self.B:
            return [st]
        return [st._replace(x=st.x[b], P=st.P[b], lm_active=st.lm_active[b],
                            lm_unobserved=st.lm_unobserved[b],
                            lm_generation=st.lm_generation[b],
                            frame_ind=st.frame_ind[b]) for b in range(self.B)]

    def _noise(self, b: int, i: int) -> torch.Tensor:
        j = i % self.L
        return self.noise[b, j] if self.B else self.noise[j]

    def _judge(self, step_of, start: bool = True) -> list:
        """Readings of the start (the reference's bootstrap against the
        program's) and of every sampled frame, each instance's post state
        (``step_of``'s) against the float64 reference's step from its pre
        state: one dict a judged step."""
        steps, w, rp = self._ref(torch.float64)
        std = self.cfg["matcher"]["detection_noise_std"]
        out = [state_errs(self.init, steps.init_gt(
            rp, w, self.K, self.init_noise, std))] if start else []
        for s in self.samples:
            pres, posts = self._instances(s.pre), self._instances(s.post)
            for b, (pre, post) in enumerate(zip(pres, posts)):
                ref = steps.gt_step(rp, w, steps.state_as(pre, torch.float64),
                                    s.f, self._noise(b, s.i), std)
                out.append(state_errs(step_of(b, s, pre, post), ref))
        return out

    def check(self) -> dict:
        return worst(self._judge(lambda b, s, pre, post: post))

    def control(self) -> dict:
        """The reference in the program's place, one precision lower."""
        dt, low = lower_precision(self.cfg)
        steps, w, rp = self._ref(dt)
        std = self.cfg["matcher"]["detection_noise_std"]

        def step_of(b, s, pre, post):
            with low():
                return steps.gt_step(rp, w, steps.state_as(pre, dt), s.f,
                                     self._noise(b, s.i), std)
        return worst_finite(self._judge(step_of, start=False))
