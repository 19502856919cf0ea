"""surikatoko-tpu-torch: the MonoSlam on-device closed loops in PyTorch.

A port of the ``surikatoko_tpu`` JAX package to PyTorch and CUDA for one
NVIDIA Hopper card (H100). The JAX package stays beside it as the reference
the port is tested against; this package imports ``torch`` and numpy and never
``jax`` (nor ``surikatoko_tpu``, whose ``__init__`` imports jax).

Layer map (mirrors ``surikatoko_tpu``; the on-device loops are ported):
  geom/      quaternions, SE(3), pinhole camera, uncertainty ellipses,
             similarity alignment (ATE), rectangles
  vision/    ZNCC surface (plain version of the search kernel), Shi-Tomasi,
             pyramidal KLT, the NCC and KLT matchers, PNM pictures, BRIEF
             descriptors, scale-space keypoints, place recognition
  io/        the native PGM frame loader, the tracker log, the BA formats,
             checkpoints
  world/     scenarios, the on-device runners (scenario03 with the GT
             matcher, the image sequence) and the host-driven runners (the
             GT matcher's scenario loop, the image-sequence loops)
  models/    the MonoSlam EKF: state, measurement, predict, the four update
             strategies, fused congruence, health, the host-driven filter;
             bundle adjustment; multi-view factorization (mvf/) and the
             SE(3) / Sim(3) pose graphs (posegraph); the two-view toolbox
             (sfm/)
  ops/       batched NCC search and the covariance downdate, with their
             hand-written CUDA kernels (csrc/)
  demos/     the multi-view factorization demo and the at-scale MVF
             pipeline as runners that return their metrics
  utils/     closeness, streaming stats, sampling and propagation,
             Gauss-Jordan, profiling hooks

Nothing here touches a GPU or a compiler at import time: each CUDA kernel
is built on its first launch (ops/cuda_build.py).
"""

from surikatoko_tpu_torch import config as config

__version__ = "0.1.0"
