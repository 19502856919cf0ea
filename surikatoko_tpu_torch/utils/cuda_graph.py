"""CUDA graphs of the port's device work: the one place that knows how a
graph is engaged, keyed, warmed up, captured, replayed, named and counted.
The scan runners' one-frame call (``world/device_runner``, named
``frame``) and the device-loop LM's blocks and trial
(``models/ba/lm_device``, named ``ba`` or ``posegraph``) replay through it.

The rules, each said only here:

- Engage (:func:`graphable`): every tensor of the call is a CUDA tensor
  that does not require grad and is not wrapped by ``torch.func``, and no
  capture is under way on the current stream. Anything else runs eagerly.
- Key (:func:`key`): the shape, dtype and device of each tensor the owner
  copies into a static buffer, and the identity (data pointer, shape,
  dtype) of each tensor the graph reads in place. A new key is a new
  graph.
- Warm up, capture, replay (:class:`Graph`): ``work()`` reads only static
  buffers, which the owner filled on the caller's stream beforehand, and
  tensors read in place. At the first call the device's one side stream
  waits for the caller's, runs ``work()`` once eagerly (the lazy set-up
  of cuBLAS, cuSOLVER and the allocator, as ``torch.cuda.graphs`` asks),
  captures ``work()`` into a graph with a memory pool of its own, and the
  caller's stream waits for it; then the graph replays. Every later call
  replays only. A call returns the graph's static outputs, which the next
  replay overwrites: the owner copies or clones what it hands on.
- Name: counters ``<name>.graph_captures`` (one a capture) and
  ``<name>.graph_replays`` (one a replay, the one right after a capture
  included); the span ``<name>.graph`` around a replay of a graph that an
  earlier call captured, and only there.
- Keep (:class:`Store`): one owner-kept graph a key. What to keep and when
  to clear is the owner's.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterable

import torch

from surikatoko_tpu_torch.utils.profiling import count, span


def graphable(tensors: Iterable) -> bool:
    """Whether a call over ``tensors`` may replay a graph: every item a CUDA
    tensor that does not require grad and is not wrapped by ``torch.func``,
    and no capture under way on the current stream."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return (all(isinstance(t, torch.Tensor) and t.is_cuda
                and not t.requires_grad and not wrapped(t) for t in tensors)
            and not torch.cuda.is_current_stream_capturing())


def key(copied: Iterable[torch.Tensor],
        in_place: Iterable[torch.Tensor] = ()) -> tuple:
    """A graph's key: (shape, dtype, device) of each tensor copied into a
    static buffer, (data pointer, shape, dtype) of each tensor the graph
    reads in place."""
    return (tuple((t.shape, t.dtype, t.device) for t in copied),
            tuple((t.data_ptr(), t.shape, t.dtype) for t in in_place))


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream that every warm-up and capture on ``device`` runs on:
    cuBLAS keeps a workspace for each stream that calls it (32 MiB on an
    H100), so a stream a graph would grow the memory peak with each
    capture."""
    return torch.cuda.Stream(device)


class Graph:
    """One piece of device work on ``device``, captured at its first call
    and replayed at every call; ``name`` names its span and counters."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device
        self.graph = self.out = None

    def __call__(self, work: Callable[[], Any]) -> Any:
        """Replays the graph of ``work`` (captured now if this is the first
        call) and returns its static outputs."""
        if self.graph is None:
            self._capture(work)
            self.graph.replay()
        else:
            with span(self.name + ".graph"):
                self.graph.replay()
        count(self.name + ".graph_replays")
        return self.out

    def _capture(self, work) -> None:
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            side = _side_stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                work()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin()
                try:
                    out = work()
                finally:
                    graph.capture_end()
            cur.wait_stream(side)
        self.graph, self.out = graph, out
        count(self.name + ".graph_captures")


class Store:
    """Owner-kept graphs (or whatever holds them), one a :func:`key`."""

    def __init__(self):
        self._items = {}

    def get(self, k: tuple, make: Callable[[], Any]) -> Any:
        """The item at ``k``, made by ``make()`` if there is none."""
        got = self._items.get(k)
        if got is None:
            got = self._items[k] = make()
        return got

    def clear(self) -> None:
        self._items.clear()
