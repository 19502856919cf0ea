"""Process groups over the landmark axis.

Port of ``surikatoko_tpu/parallel/mesh.py``. JAX's "lm" mesh axis is a
``torch.distributed`` process group here: each rank holds one block of
landmark rows (EKF covariance rows, BA point blocks). The default group
must be initialized (``launch.run_ranks``, ``multihost.initialize``).
"""

from __future__ import annotations

import torch.distributed as dist

# groups of the first n ranks, made once per process (making one is a
# collective call of every rank of the world, in the same order)
_GROUPS: dict = {}


def landmark_group(n: int | None = None):
    """The process group of the first ``n`` ranks (every rank of the world
    must call this, members or not), or the world group for ``n`` None or
    the world's size. A rank outside it gets
    ``dist.GroupMember.NON_GROUP_MEMBER`` (see :func:`is_member`)."""
    world = dist.get_world_size()
    if n is None or n == world:
        return dist.group.WORLD
    if not 1 <= n <= world:
        raise ValueError(f"a group of {n} ranks in a world of {world}")
    if n not in _GROUPS:
        _GROUPS[n] = dist.new_group(list(range(n)))
    return _GROUPS[n]


def is_member(group) -> bool:
    """Whether this rank belongs to ``group``."""
    return group is not dist.GroupMember.NON_GROUP_MEMBER


def device_count(group=None) -> int:
    """Ranks of ``group`` (default the world): the mesh size."""
    return dist.get_world_size(group)
