"""surikatoko-tpu-torch: the MonoSlam image-sequence closed loop in PyTorch.

A port of the ``surikatoko_tpu`` JAX package to PyTorch and CUDA for one
NVIDIA Hopper card (H100). The JAX package stays beside it as the reference
the port is tested against; this package imports ``torch`` and numpy and never
``jax`` (nor ``surikatoko_tpu``, whose ``__init__`` imports jax).

Layer map (mirrors ``surikatoko_tpu``; only the flagship slice is ported):
  geom/      quaternions, SE(3), pinhole camera, similarity alignment (ATE)
  vision/    ZNCC surface (plain version of the search kernel), Shi-Tomasi
  world/     scenario builders and the on-device image-sequence runner
  models/    the MonoSlam EKF: state, measurement, predict, fused congruence
  ops/       batched NCC search and its hand-written CUDA kernel (csrc/)

Nothing here touches a GPU or a compiler at import time: the CUDA kernel is
built on its first launch (ops/ncc_cuda.py).
"""

from surikatoko_tpu_torch import config as config

__version__ = "0.1.0"
