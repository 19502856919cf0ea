"""Distribution layer: process groups and the sharded EKF, imageseq and
Schur kernels.

Port of ``surikatoko_tpu/parallel``. JAX runs its sharded functions from one
process over a device mesh (``shard_map``); here every rank is a process of
a ``torch.distributed`` group that runs the same code on its own rows
(landmark-sharded covariance rows, point-sharded BA blocks), with NCCL
collectives between cards and gloo between CPU processes (the tests).
``launch.run_ranks`` starts such a group on one host.
"""

from surikatoko_tpu_torch.parallel.mesh import (
    device_count as device_count,
    landmark_group as landmark_group,
)
