"""Multi-host initialization of the distribution layer.

Port of ``surikatoko_tpu/parallel/multihost.py``. There is no custom
transport: ``torch.distributed.init_process_group`` brings up one process
per card (NCCL between cards, NVLink within a host, the network across
hosts; gloo for CPU processes), and the sharded functions run on the
groups of ``parallel.mesh``.

Deployment recipe (2 hosts x 8 cards, one process per card):

  torchrun --nnodes 2 --nproc-per-node 8 --rdzv-endpoint HOST:PORT app.py
  # in app.py, before any collective:
  multihost.initialize()          # reads torchrun's environment
  update = make_sharded_stacked_update(params, capacity, landmark_group())

or without torchrun, on every process: ``multihost.initialize(
"HOST:PORT", num_processes, process_id)``.

The per-frame traffic is the EKF's one all_gather of the gain precursor
A [2K, D] (packed with the Jacobians and residuals) and the Schur solve's
one all_reduce of the reduced system; the O(D^2 K / n) downdate stays on
each card's own rows.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: torch.device | str = "cuda",
               timeout_s: float = 600.0) -> None:
    """Join the default process group (a no-op once joined).

    ``coordinator_address`` is "host:port" of rank 0's TCP store; with no
    arguments torchrun's environment gives them (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK; LOCAL_RANK picks the card). The backend is NCCL for a
    card (the default) and gloo for ``device="cpu"``; a failed NCCL
    initialization raises."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
                               if "MASTER_ADDR" in env else None)
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        raise ValueError("no coordinator address: pass one or run under "
                         "torchrun")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s))


def is_multihost() -> bool:
    """More than one process in the default group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_slice_info() -> dict:
    """This process's place in the default group."""
    cuda = dist.get_backend() == "nccl"
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "global_devices": dist.get_world_size(),
        "backend": dist.get_backend(),
    }
