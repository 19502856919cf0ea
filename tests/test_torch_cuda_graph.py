"""The CUDA-graph helper's rules that need no card (``utils/cuda_graph``):
the engage test refuses a CPU tensor, a tensor that requires grad, one
wrapped by ``torch.func``, a field that is not a tensor and a call during a
capture, each against the same call that engages (``is_cuda`` and the
capture query stubbed, as a CPU build has no card to ask); the key tells a
copied tensor's shape or dtype and an in-place tensor's storage apart from
an equal call; the store makes an item once a key until cleared. Replay,
capture and spans are tests/test_torch_cuda_graph_cuda.py's."""

import pytest
import torch

from surikatoko_tpu_torch.utils import cuda_graph


@pytest.fixture
def card_like(monkeypatch):
    """Every tensor reports itself a CUDA tensor, and no capture is under
    way unless the test says so."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    return capturing


def _under_func(transform):
    """graphable of the tensor that ``transform`` hands its function."""
    seen = []

    def f(t):
        seen.append(cuda_graph.graphable([torch.ones(2), t]))
        return (t * t).sum()
    x = torch.ones(3, 2)
    if transform == "vmap":
        torch.func.vmap(f)(x)
    else:
        torch.func.grad(f)(x)
    return seen[0]


def test_torch_graphable_engages_plain_card_tensors(card_like):
    assert cuda_graph.graphable([torch.ones(2), torch.zeros(3, 4)])
    assert cuda_graph.graphable([])


@pytest.mark.parametrize("case", ["grad", "vmap", "func_grad", "not_tensor",
                                  "capturing"])
def test_torch_graphable_refuses(case, card_like):
    if case == "grad":
        assert not cuda_graph.graphable([torch.ones(2),
                                         torch.ones(2, requires_grad=True)])
    elif case in ("vmap", "func_grad"):
        assert not _under_func("vmap" if case == "vmap" else "grad")
    elif case == "not_tensor":
        assert not cuda_graph.graphable([torch.ones(2), 1.0])
    else:
        card_like[0] = True
        assert not cuda_graph.graphable([torch.ones(2)])


def test_torch_graphable_refuses_a_cpu_tensor():
    assert not cuda_graph.graphable([torch.ones(2)])


@pytest.mark.parametrize("change,same", [
    ("none", True),
    ("copied_new_storage", True),
    ("copied_shape", False),
    ("copied_dtype", False),
    ("in_place_new_storage", False),
    ("in_place_shape", False),
])
def test_torch_graph_key(change, same):
    copied, in_place = torch.zeros(4, 2), torch.arange(6.0)
    k = cuda_graph.key([copied], [in_place])
    c2, p2 = {
        "none": (copied, in_place),
        "copied_new_storage": (copied.clone(), in_place),
        "copied_shape": (torch.zeros(5, 2), in_place),
        "copied_dtype": (copied.double(), in_place),
        "in_place_new_storage": (copied, in_place.clone()),
        "in_place_shape": (copied, in_place[:4]),
    }[change]
    assert (cuda_graph.key([c2], [p2]) == k) == same


def test_torch_graph_store_makes_once_a_key_until_cleared():
    store, made = cuda_graph.Store(), []

    def make(tag):
        made.append(tag)
        return object()
    k1 = cuda_graph.key([torch.zeros(2)])
    k2 = cuda_graph.key([torch.zeros(3)])
    a = store.get(k1, lambda: make(1))
    assert store.get(k1, lambda: make(2)) is a
    b = store.get(k2, lambda: make(3))
    assert b is not a and made == [1, 3]
    store.clear()
    assert store.get(k1, lambda: make(4)) is not a and made == [1, 3, 4]
