"""Dtype and numerics policy of the port.

* CPU parity tests run in float64, like the JAX package's tests (the C++
  reference is f64).
* On the card the filter runs in float32 with every reduced-precision path
  off: TF32 in cuBLAS matmuls and cuDNN convolutions NaNs the innovation
  Cholesky after a few dozen chained updates (the JAX package pins
  ``jax_default_matmul_precision="highest"`` for the same reason).
"""

from __future__ import annotations

import torch


def default_dtype(device: torch.device | str) -> torch.dtype:
    """float64 on the CPU (parity tests), float32 on the card."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def set_full_precision() -> None:
    """Turn TF32 off for matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def precision_flags() -> dict:
    """The flags :func:`set_full_precision` sets, as they stand now."""
    return {
        "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
