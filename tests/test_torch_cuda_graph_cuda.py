"""The CUDA-graph helper on the card (``utils/cuda_graph``): the first call
of a :class:`Graph` runs ``work`` twice (the warm-up and the capture),
counts one capture and one replay, and opens no ``<name>.graph`` span; a
later call only replays, under the span, and reads what the owner wrote
into the static buffers since; a store cleared makes the next call
capture again; more captures on a device add no cuBLAS workspace (they
share one side stream); the engage test takes a CUDA tensor and refuses a
CPU one and any call during a capture. Imports no JAX, so it runs where
the card is:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_graph_cuda.py -m cuda -q

Without a CUDA device every case skips."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from surikatoko_tpu_torch.utils import cuda_graph, profiling

NAME = "cgtest"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured only on a card")
    return torch.device("cuda", 0)


def _counts():
    c = profiling.counts()
    return [c.get(f"{NAME}.{k}", 0) for k in ("graph_captures",
                                               "graph_replays")]


def _traced(fn):
    """(fn's result, the names of the program's spans while it ran)."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        torch.cuda.synchronize()
    return out, [s.name for s in profiling.window()]


class _Owner:
    """A static buffer and work that reads it; counts work's calls."""

    def __init__(self, dev):
        self.x = torch.zeros(64, device=dev)
        self.graph = cuda_graph.Graph(NAME, dev)
        self.calls = 0

    def work(self):
        self.calls += 1
        return torch.linalg.norm(self.x.view(8, 8) @ self.x.view(8, 8).T) + 1

    def __call__(self, v: float):
        self.x.fill_(v)
        return self.graph(self.work).clone()


def _want(v: float, dev) -> torch.Tensor:
    x = torch.full((8, 8), v, device=dev)
    return torch.linalg.norm(x @ x.T) + 1


@pytest.mark.cuda
def test_torch_graph_first_call_captures_then_replays():
    dev = _card()
    own, c0 = _Owner(dev), _counts()
    out, spans = _traced(lambda: own(0.5))
    assert own.calls == 2
    assert [b - a for a, b in zip(c0, _counts())] == [1, 1]
    assert f"{NAME}.graph" not in spans
    torch.testing.assert_close(out, _want(0.5, dev))
    for v in (1.5, -2.0):
        out, spans = _traced(lambda: own(v))
        assert spans.count(f"{NAME}.graph") == 1
        torch.testing.assert_close(out, _want(v, dev))
    assert own.calls == 2
    assert [b - a for a, b in zip(c0, _counts())] == [1, 3]


@pytest.mark.cuda
def test_torch_graph_store_cleared_captures_again():
    dev = _card()
    store, c0 = cuda_graph.Store(), _counts()
    x = torch.ones(16, device=dev)
    k = cuda_graph.key([x])
    for _ in range(2):
        own = store.get(k, lambda: _Owner(dev))
        own(1.0)
        own(2.0)
    assert store.get(k, lambda: None) is own
    assert [b - a for a, b in zip(c0, _counts())] == [1, 4]
    store.clear()
    again = store.get(k, lambda: _Owner(dev))
    assert again is not own
    torch.testing.assert_close(again(3.0), _want(3.0, dev))
    assert [b - a for a, b in zip(c0, _counts())] == [2, 5]


@pytest.mark.cuda
def test_torch_graph_captures_share_one_workspace():
    """Four more graphs of a matmul after the first add a few bytes each,
    not the 32 MiB workspace cuBLAS keeps for every stream it runs on."""
    dev = _card()
    owners = [_Owner(dev)]
    owners[0](1.0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    for v in range(4):
        owners.append(_Owner(dev))
        torch.testing.assert_close(owners[-1](float(v)), _want(float(v), dev))
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) - before < 8 * 2 ** 20


@pytest.mark.cuda
def test_torch_graphable_on_the_card():
    dev = _card()
    x = torch.ones(4, device=dev)
    assert cuda_graph.graphable([x])
    assert not cuda_graph.graphable([x, torch.ones(4)])
    seen = []
    g, s = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        g.capture_begin()
        try:
            seen.append(cuda_graph.graphable([x * 2]))
        finally:
            g.capture_end()
    torch.cuda.current_stream(dev).wait_stream(s)
    assert seen == [False]
