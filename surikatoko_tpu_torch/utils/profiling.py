"""Profiling hooks: per-frame wall clock and device tracing.

Port of ``surikatoko_tpu/utils/profiling.py``: the reference's chrono
timers around ProcessFrame (demo-davison-mono-slam.cpp:1736-1741, the
"track=..ms | ..fps" line), and ``torch.profiler`` traces (Chrome trace
JSON, viewable in Perfetto or TensorBoard) in place of ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@dataclass
class FrameTimer:
    """Streaming frame-duration stats (the 'track=..ms | ..fps' line)."""

    durations: list = field(default_factory=list)
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        return False

    @property
    def last_ms(self) -> float:
        return self.durations[-1] * 1e3 if self.durations else 0.0

    @property
    def avg_ms(self) -> float:
        return (sum(self.durations) / len(self.durations) * 1e3
                if self.durations else 0.0)

    @property
    def fps(self) -> float:
        return 1e3 / self.last_ms if self.last_ms > 0 else 0.0

    def format_line(self) -> str:
        return f"track={self.last_ms:.1f}ms | {self.fps:.1f}fps"


@contextlib.contextmanager
def device_trace(log_dir: str, device: torch.device | str = "cuda"):
    """A ``torch.profiler`` trace of everything inside the block (the host
    and, for a CUDA ``device``, the card), written to ``log_dir`` as a
    Chrome trace when the block ends."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region in device traces (``record_function``)."""
    with record_function(name):
        yield


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` takes on the card: CUDA events around
    ``reps`` back-to-back calls after three warm-up calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, host_ops: bool = True):
    """(device busy us, device launches, top kernels, {kernel: [us,
    launches]} of all) of one call of ``fn`` under torch.profiler. The
    device-side events are the kernels and copies themselves; the aten rows
    of key_averages() repeat their time, so only these are summed. Without
    ``host_ops`` the profiler records the device alone, which costs the
    host far less over runs of many small launches."""
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return (sum(v[0] for v in kernels.values()),
            sum(v[1] for v in kernels.values()),
            [[k[:100], v[0], v[1]] for k, v in top], kernels)
