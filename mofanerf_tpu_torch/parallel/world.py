"""Start a world of ranks on one host, one process each, and collect what
each returns.

`run_world(fn, n, payload)` spawns n processes (torch.multiprocessing, start
method "spawn": a rank imports torch and the port afresh, nothing of its
parent), joins them in a `file://` store in a new directory (inside
`workdir` when given), calls
`fn(device, payload)` on each and returns the ranks' results in rank order.
`fn` must be a module-level function of an importable module and its result
plain containers of tensors and numbers (they cross back through
`torch.save`). Every world is joined under its own time limit: a rank that
fails stops the others and raises here, and a world still running at
`timeout_s` is killed and raises TimeoutError.

On the card every rank takes card rank % device_count: NCCL needs one card a
rank; ranks sharing a card use gloo (`backend="gloo"`). `single_rank` is a
world of one in the calling process."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mofanerf_tpu_torch.parallel.mesh import init_distributed
from mofanerf_tpu_torch.utils.device import resolve_device


def _rank_main(rank, fn, world_size, workdir, payload, device, backend):
    torch.set_num_threads(1)   # ranks share the host's cores
    dev = init_distributed(device, backend, init_method=f"file://{workdir}/store", rank=rank,
                           world_size=world_size, local_rank=rank)
    try:
        result = fn(dev, payload)
        torch.save(result, os.path.join(workdir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def single_rank(device="cuda", workdir: str | None = None):
    """A world of one rank in this process (a file:// store in a new
    directory inside `workdir`): yields its device; the group is destroyed
    after the block."""
    with tempfile.TemporaryDirectory(prefix="world1-", dir=workdir) as work:
        dev = init_distributed(device, init_method=f"file://{work}/store", rank=0,
                               world_size=1, local_rank=0)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def run_world(fn, world_size: int, payload=None, workdir: str | None = None, device="cuda",
              backend: str | None = None, timeout_s: float = 120.0) -> list:
    """fn(device, payload) on `world_size` ranks; their results in rank order."""
    resolve_device(device)   # no card: raise here, before any rank starts
    with tempfile.TemporaryDirectory(prefix=f"world{world_size}-", dir=workdir) as work:
        ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False, start_method="spawn",
                                 args=(fn, world_size, work, payload, device, backend))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {world_size} ranks was still running after "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        return [torch.load(os.path.join(work, f"result_{r}.pt"), weights_only=True)
                for r in range(world_size)]
