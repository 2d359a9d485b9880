"""A world of CPU processes for the port's sharded tests (JAX-free, so that
the spawned children import no JAX).

`run_world(n, target, args, tmp)` spawns n processes that join one gloo
process group through a FileStore under `tmp` (no port to clash with other
xdist workers; a collective waits at most COLLECTIVE_TIMEOUT, so that ranks
that hang fail), runs `target(rank, *args)` in each with one torch thread,
and returns every rank's return value, in rank order. A rank that raises
fails the call with its traceback; the others are killed. `start_world`
returns the started world, whose `results()` waits for it, so that the
caller can work meanwhile.
"""

from __future__ import annotations

import datetime
import os
import queue
import traceback

import torch
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=240)


def _child(rank, n, store, target, args, q):
    torch.set_num_threads(1)
    try:
        from videoswap_torch.parallel import dist as vdist
        vdist.initialize('cpu', f'file://{store}', rank, n,
                         timeout=COLLECTIVE_TIMEOUT)
        out = target(rank, *args)
        vdist.shutdown()
        q.put((rank, True, out))
    except BaseException:        # noqa: BLE001 - reported to the parent
        q.put((rank, False, traceback.format_exc()))


class World:
    def __init__(self, n: int, target, args: tuple, tmp):
        ctx = mp.get_context('spawn')
        self.n, self.q = n, ctx.Queue()
        store = os.path.join(str(tmp), 'world_store')
        self.procs = [ctx.Process(target=_child,
                                  args=(r, n, store, target, args, self.q))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 300.0) -> list:
        out = {}
        try:
            for _ in self.procs:
                rank, ok, value = self.q.get(timeout=timeout)
                if not ok:
                    raise RuntimeError(f'rank {rank} failed:\n{value}')
                out[rank] = value
        except queue.Empty:
            raise RuntimeError(f'the world of {self.n} timed out after '
                               f'{timeout} s')
        finally:
            for p in self.procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
        return [out[r] for r in range(self.n)]


def start_world(n: int, target, args: tuple, tmp) -> World:
    return World(n, target, args, tmp)


def run_world(n: int, target, args: tuple, tmp, timeout: float = 300.0):
    return start_world(n, target, args, tmp).results(timeout)
