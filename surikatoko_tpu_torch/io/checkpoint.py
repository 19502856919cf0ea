"""Checkpoint/resume for tracker state and BA problems.

Port of ``surikatoko_tpu/io/checkpoint.py``: a nested structure of tensors
(a NamedTuple such as ``MonoSlamState``, tuples, lists, dicts) round-trips
through one .npz file in the JAX package's layout: the leaves as
``leaf_<i>`` in flattening order (NamedTuple and tuple fields in order,
dict keys sorted, ``None`` dropped, as ``jax.tree.flatten`` orders them)
plus a ``treedef`` string. So a checkpoint the JAX package wrote from its
``MonoSlamState`` loads into the port's. Writes are atomic (a temporary
file, then a rename).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in flattening order."""
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        items = [_unflatten(x, leaves) for x in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return type(like)(items)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def _describe(tree) -> str:
    """The structure as a string, leaves shown as '*'."""
    if tree is None:
        return "None"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(x) for x in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pytree(path: str, tree) -> None:
    payload = {f"leaf_{i}": _host(x) for i, x in enumerate(_flatten(tree))}
    payload["treedef"] = np.frombuffer(
        json.dumps(_describe(tree)).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_pytree(path: str, like):
    """Load into the structure of ``like`` (an example with the same
    structure, e.g. a freshly initialized state): each leaf keeps the dtype
    it was saved in and goes to the device of ``like``'s leaf."""
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        arrays = [z[f"leaf_{i}"] for i in range(n)]
    like_leaves = _flatten(like)
    if len(like_leaves) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, expected {len(like_leaves)}")
    leaves = [torch.as_tensor(a, device=getattr(l, "device", "cpu"))
              for a, l in zip(arrays, like_leaves)]
    return _unflatten(like, iter(leaves))
