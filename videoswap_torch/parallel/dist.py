"""Multi-process scaffolding (the port of videoswap_tpu/parallel/dist.py).

A sharded run is one process a rank, started by `torchrun` (which sets
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) or by a
launcher that passes the rank, the world size and a rendezvous address
itself (`initialize(..., init_method=, rank=, world_size=)`).

- `maybe_initialize_distributed` starts the process group when a
  multi-process run is requested (a flag, or torchrun's `WORLD_SIZE` > 1);
  `join_world(n, what)` starts it for a run that needs exactly n ranks
  and refuses any other world;
- `is_main_process`, `rank`, `world_size`, `barrier`: the IO gate and the
  synchronisation of the reference's accelerate run;
- every function is a no-op in a single-process run.

The backend follows the layout of the devices, never a silent fallback:
NCCL where every local rank has a GPU of its own, gloo where ranks share
one GPU (NCCL refuses two ranks on one device) or run on the CPU. Each
rank's device is `cuda:{LOCAL_RANK % device_count}`.

Every collective waits at most `TIMEOUT` (or the `timeout` given to
`initialize`): a rank that died, or ranks that issue their collectives in
different orders, fail the run instead of stalling it.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger('videoswap_torch')

TIMEOUT = datetime.timedelta(minutes=10)


def distributed_requested(flag: bool = False) -> bool:
    return bool(flag or int(os.environ.get('WORLD_SIZE', '1')) > 1)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get('LOCAL_RANK', rank()))


def is_main_process() -> bool:
    return rank() == 0


def barrier(name: str = 'barrier') -> None:
    """All ranks meet here (reference `accelerator.wait_for_everyone`)."""
    if world_size() > 1:
        dist.barrier()


def rank_device(device_type: str) -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}`, or the CPU."""
    if device_type != 'cuda':
        return torch.device(device_type)
    return torch.device('cuda', local_rank() % torch.cuda.device_count())


def choose_backend(device_type: str, local_world: int) -> str:
    """NCCL where each of the `local_world` ranks of this host has a GPU of
    its own; gloo where they share GPUs, or on the CPU."""
    if device_type == 'cuda' and torch.cuda.device_count() >= local_world:
        return 'nccl'
    return 'gloo'


def initialize(device_type: str = 'cuda', init_method: str = 'env://',
               rank: int | None = None,
               world_size: int | None = None,
               timeout: datetime.timedelta | None = None) -> str:
    """Start the process group; returns the backend. `init_method`, `rank`
    and `world_size` default to torchrun's environment."""
    if is_initialized():
        return dist.get_backend()
    n = world_size if world_size is not None else int(
        os.environ.get('WORLD_SIZE', '1'))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', n))
    backend = choose_backend(device_type, local_world)
    kw = {} if rank is None else {'rank': rank, 'world_size': n}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout or TIMEOUT, **kw)
    if device_type == 'cuda':
        torch.cuda.set_device(rank_device('cuda'))
    log.info('process group: rank %d of %d, backend %s (%d local ranks, '
             '%d devices)', dist.get_rank(), dist.get_world_size(), backend,
             local_world, torch.cuda.device_count() if device_type == 'cuda'
             else 0)
    return backend


def maybe_initialize_distributed(flag: bool = False,
                                 device_type: str = 'cuda') -> bool:
    """Start the process group when a multi-process run is requested.
    Returns True if the group is (now) initialised."""
    if is_initialized():
        return True
    if not distributed_requested(flag):
        return False
    initialize(device_type)
    return True


def join_world(n: int, what: str, device_type: str = 'cuda') -> None:
    """Start the process group of a run that needs exactly `n` ranks (a
    torchrun world of `n` processes); any other world is refused before it
    starts."""
    have = int(os.environ.get('WORLD_SIZE', '1'))
    if have != n:
        raise ValueError(f'{what} needs {n} ranks; the world has {have} '
                         f'(run it under torchrun --nproc_per_node {n})')
    maybe_initialize_distributed(n > 1, device_type)


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
