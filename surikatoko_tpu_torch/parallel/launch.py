"""Start a group of ranks on one host and run package functions on them.

JAX runs its sharded code on several devices of one process; a
``torch.distributed`` group needs one process per rank. :class:`RankPool`
spawns n ranks (``torch.multiprocessing``, spawn start), joins them in a
group through a TCP store on a free localhost port (NCCL for cards, one card
a rank; gloo for ``device="cpu"``), and then runs any number of calls on
every rank, each rank's result coming back as numpy. :func:`run_ranks` is
one call on a pool of its own. A function run on the ranks must be one a
rank can import (a module of this package, or the script run as
``__main__``), so that a rank imports only torch and the port.

    with RankPool(4, device="cpu") as pool:
        outs = pool.run(call_with_group, 2, make_sharded_fused_step,
                        (params, K), (x, P, obs, obs_mask))
"""

from __future__ import annotations

import queue
import socket
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from surikatoko_tpu_torch.parallel import mesh


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def to_numpy(obj):
    """``obj`` with every tensor as a numpy array (NamedTuples, tuples,
    lists and dicts kept)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    return obj


def call_with_group(n: int, make, make_args: tuple = (), call_args=None,
                    make_kwargs: dict | None = None):
    """Rank body: on the first ``n`` ranks, ``make(*make_args,
    group=landmark_group(n), **make_kwargs)`` and, with ``call_args``, the
    call of what it returns on them; None on the other ranks."""
    group = mesh.landmark_group(n)
    if not mesh.is_member(group):
        return None
    out = make(*make_args, group=group, **(make_kwargs or {}))
    return out if call_args is None else out(*call_args)


def _rank_main(rank: int, n: int, port: int, device: str, tasks, results,
               timeout_s: float) -> None:
    torch.set_num_threads(1)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                out = to_numpy(fn(*args, **kwargs))
                if cuda:
                    torch.cuda.synchronize()
                results.put((rank, True, out))
            except Exception:       # reported to the caller, who raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """n ranks of one process group on this host (see the module doc).
    ``device`` "cuda" gives rank r card r mod the card count and NCCL;
    "cpu" gloo. Use as a context manager; :meth:`close` stops every rank."""

    def __init__(self, n: int, device: torch.device | str = "cuda",
                 timeout_s: float = 600.0):
        self.n = n
        self.device = torch.device(device).type
        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank pool needs a CUDA device")
        self.timeout_s = timeout_s
        self._procs = []

    def __enter__(self) -> "RankPool":
        ctx = mp.get_context("spawn")
        port = free_port()
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        for r in range(self.n):
            p = ctx.Process(target=_rank_main,
                            args=(r, self.n, port, self.device, self._tasks[r],
                                  self._results, self.timeout_s),
                            daemon=True)
            p.start()
            self._procs.append(p)
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; returns the ranks' results
        in rank order, tensors as numpy. Raises (and stops the pool) if a
        rank raises or dies."""
        for q in self._tasks:
            q.put((fn, args, kwargs))
        outs = [None] * self.n
        pending = set(range(self.n))
        waited = 0.0
        while pending:
            try:
                rank, ok, out = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r in pending if not self._procs[r].is_alive()]
                if dead or waited > self.timeout_s:
                    self.close()
                    raise RuntimeError(f"ranks {sorted(pending)} gave no "
                                       f"result (dead: {dead})")
                continue
            if not ok:
                self.close()
                raise RuntimeError(f"rank {rank} raised:\n{out}")
            outs[rank] = out
            pending.discard(rank)
        return outs

    def close(self) -> None:
        """Stop every rank: a clean exit if they are idle, else killed."""
        for p, q in zip(self._procs, getattr(self, "_tasks", [])):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []


def run_ranks(fn, n: int, *args, device: torch.device | str = "cuda",
              **kwargs) -> list:
    """``fn(*args, **kwargs)`` once on each of ``n`` new ranks (a pool of
    its own, stopped after); the ranks' results as numpy, in rank order."""
    with RankPool(n, device=device) as pool:
        return pool.run(fn, *args, **kwargs)


def first(outs: list):
    """Rank 0's result, after checking that every other member's is equal
    (replicated outputs; None from a rank outside the group is skipped)."""
    ref = outs[0]
    for o in outs[1:]:
        if o is not None:
            _assert_equal(o, ref)
    return ref


def _assert_equal(a, b) -> None:
    if isinstance(a, np.ndarray):
        if not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            raise AssertionError("ranks returned different arrays")
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b, strict=True):
            _assert_equal(x, y)
    elif isinstance(a, dict):
        for k in a:
            _assert_equal(a[k], b[k])
    elif a != b:
        raise AssertionError(f"ranks returned {a!r} and {b!r}")
