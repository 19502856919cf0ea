"""The port's tracing: named spans at the layer boundaries of a frame, call
counters, and device timing.

``span(name)`` marks a region of the program. It is on exactly while a
``torch.profiler`` session records, and costs one global read and one
branch otherwise (a shared no-op context). While on, it enters
``record_function(name)``, so the region shows on the trace's host and
device timelines, and appends a :class:`Span` to an in-memory record whose
clock is the profiler events' own (``time.time_ns()``, the Unix clock that
kineto stamps its events with), so a span lines up with the kernels of the
same trace. Each profiler session starts a new record; :func:`window`
returns the latest one. ``spanned(name)`` makes every call of a function
a span. Spans of the MonoSlam frame:

  ``frame``                 one frame of a loop (one batched step under
                            ``torch.func.vmap``): the scan runners' frame
                            bodies and ``MonoSlamFilter.process_frame``
  ``frame.graph``           a replay of the CUDA graph of one frame that
                            an earlier call captured (the scan runners'
                            one-frame calls on a card, ``utils/cuda_graph``),
                            inside ``frame``; the spans below do not run
                            in a replay
  ``frame.match``           the GT matcher's projection (scan runner)
  ``frame.update``          Jacobians, H P, the innovation, its Cholesky
                            and triangular solve, the correction
                            (``fused_step._fused_update_core``,
                            ``update.stacked_update``)
  ``frame.predict``         the camera epilogue and the covariance predict
  ``frame.health``          ``process_frame``'s self-healing and removal
  ``frame.recruit``         new landmarks (``landmarks.add_landmarks``, the
                            image loop's recruit rows)
  ``frame.render``, ``frame.search``   the image loop's frame and NCC search
  ``b1``, ``b2``            a call of kernel B1 (NCC) or B2 (downdate),
                            plain version included
  ``matcher.match``, ``matcher.recruit``, ``matcher.book``   the host
                            matchers' calls
  ``host_read``             a transfer that makes the host wait for the
                            card: a device-to-host read, or a copy of a
                            pageable host array to the card (which
                            synchronizes the stream)

Spans of the incremental SfM pass (``models/mvf/session``):

  ``mvf.frame``             one keyframe of ``MvfSession.frame``: its
                            integration and the BA its index calls for
  ``mvf.integrate``         ``integrate_new_frame_corners``: inside it
                            ``mvf.localize`` (anchor, shared tracks and
                            their depths, on the host) and
                            ``mvf.triangulate`` (fresh tracks and their
                            batch; accepting and storing the points), and
                            the fused device work with its one read
  ``ba.window``, ``ba.global``   a sliding-window or a global BA; inside
                            each ``ba.build`` (the problem's assembly and
                            upload, the band plan), ``ba.blocks`` (the
                            Gauss-Newton blocks of an LM iteration) and
                            ``ba.trial`` (one damped trial: solve, apply,
                            evaluate, fetch); inside either ``ba.graph``,
                            a replay of its CUDA graph captured by an
                            earlier call (``models/ba/lm_device``)
  ``pr.describe``, ``pr.match``, ``pr.ransac``   place recognition's stages
  ``posegraph.sim3``        the Sim(3) pose graph's optimization (its LM
                            records ``posegraph.blocks``,
                            ``posegraph.trial`` and ``posegraph.graph``)

``count(name, n)`` adds to an always-on total that :func:`counts` reads:
``b1.calls``, ``b2.calls`` and ``b2.rows_calls`` count host calls of the
kernels (a replayed CUDA graph calls nothing; its capture calls once);
``frame.graph_captures`` and ``frame.graph_replays`` count the scan
runners' frame graphs captured and replayed; ``ba.runs``,
``ba.iterations`` (accepted LM steps), ``ba.trials`` (damped solves),
``ba.graph_captures`` (CUDA graphs of its blocks or trial captured) and
``ba.graph_replays`` (their launches) count bundle adjustment's LM
(``posegraph.*`` the pose graph's).

``device_trace`` writes a Chrome trace of a block; ``cuda_ms`` and
``device_profile`` time a call on the card.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function


class Span(NamedTuple):
    name: str
    parent: int      # index in the window of the innermost enclosing span, -1
    start_ns: int    # on the profiler's clock
    end_ns: int      # -1 while the span is open


_NOOP = contextlib.nullcontext()
_record: list = []   # the latest session's spans: [name, parent, start, end]
_open: list = []     # indices of its open spans, innermost last
_counts: dict = {}


class _On:
    __slots__ = ("name", "rec", "stack", "i", "rf")

    def __init__(self, name: str):
        self.name = name

    # The range's event is stamped inside its opening and closing calls,
    # which take microseconds: a span's start and end are those calls'
    # middles, still before and after any work inside the span.
    def __enter__(self):
        # the session's lists, kept: a span may close after a new one began
        rec, stack = self.rec, self.stack = _record, _open
        self.i = len(rec)
        rec.append([self.name, stack[-1] if stack else -1, 0, -1])
        stack.append(self.i)
        t0 = time.time_ns()
        self.rf = record_function(self.name)
        self.rf.__enter__()
        rec[self.i][2] = (t0 + time.time_ns()) // 2

    def __exit__(self, *exc):
        t0 = time.time_ns()
        self.rf.__exit__(*exc)
        self.rec[self.i][3] = (t0 + time.time_ns()) // 2
        if self.stack and self.stack[-1] == self.i:
            self.stack.pop()
        return False


def span(name: str):
    """A context that records the region ``name`` while a profiler session
    records; otherwise a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _On(name)


def spanned(name: str):
    """Decorator: every call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def window() -> list[Span]:
    """The spans of the latest profiler session, in the order they opened
    (a parent before its children)."""
    return [Span(*s) for s in _record]


def _new_session(start=_autograd_profiler._run_on_profiler_start):
    """Runs where torch turns the profiler's flag on, once a session."""
    global _record, _open
    _record, _open = [], []
    start()


_autograd_profiler._run_on_profiler_start = _new_session


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the total ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> dict[str, int]:
    """A copy of every total (a name never counted is absent)."""
    return dict(_counts)


@contextlib.contextmanager
def device_trace(log_dir: str, device: torch.device | str = "cuda"):
    """A ``torch.profiler`` trace of everything inside the block (the host
    and, for a CUDA ``device``, the card), written to ``log_dir`` as a
    Chrome trace when the block ends; the program's spans are in it, and
    in :func:`window` afterwards."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     log_dir)):
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
    of key_averages() repeat their time, so only these are summed; a span
    (a ``record_function`` range) shows on the device's timeline too and is
    left out. Without ``host_ops`` the profiler records the device alone,
    which costs the host far less over runs of many small launches."""
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    ranges = {e.name for e in evs if e.is_user_annotation}
    kernels: dict[str, list] = {}
    for e in evs:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation and e.name not in ranges):
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return (sum(v[0] for v in kernels.values()),
            sum(v[1] for v in kernels.values()),
            [[k[:100], v[0], v[1]] for k, v in top], kernels)
