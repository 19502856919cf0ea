"""Host <-> device copies of the host-driven pipelines, one each way: a
group of host arrays goes up as one copy (from pinned memory on the card,
so it does not block the host), and a group of device results comes back
as one packed copy (one wait for the card). Each read back is a
``host_read`` span (``utils.profiling``)."""

from __future__ import annotations

import numpy as np
import torch

from surikatoko_tpu_torch.utils.profiling import span


def host(a) -> np.ndarray:
    """A host numpy array of ``a`` (a tensor is read back)."""
    if isinstance(a, torch.Tensor):
        with span("host_read"):
            return a.detach().cpu().numpy()
    return np.asarray(a)


def send(device, dtype: torch.dtype, *arrays) -> list[torch.Tensor]:
    """Host arrays to ``device`` as one copy in ``dtype`` (booleans as 0/1,
    indices as their exact values), each back in its own shape."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(host(a), np_dtype).ravel() for a in arrays]))
    if torch.device(device).type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    else:
        flat = flat.to(device)
    out, i = [], 0
    for a in arrays:
        shape = np.shape(a)
        n = int(np.prod(shape))
        out.append(flat[i:i + n].view(shape))
        i += n
    return out


def fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Device tensors back to the host as one packed copy, in the first
    one's dtype, each in its own shape."""
    with span("host_read"):
        flat = torch.cat([t.reshape(-1).to(tensors[0].dtype)
                          for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].reshape(tuple(t.shape)))
        i += n
    return out
