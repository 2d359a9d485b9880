"""The device mesh over (dp, sp, tp) (the port of
videoswap_tpu/parallel/mesh.py), as process groups of torch.distributed.

- `dp`: data parallel (videos, or CFG halves when they divide dp x sp);
- `sp`: sequence parallel over the frame axis F of (B, F, H, W, C):
  convolutions and spatial attention are frame-local; the resnets'
  GroupNorm reduces its statistics over sp and the motion modules switch
  to location sharding with an all-to-all (Ulysses);
- `tp`: tensor parallel over the spatial attention heads and the GEGLU
  hidden units (Megatron: column-parallel in, row-parallel out with an
  all-reduce).

The JAX package lets GSPMD place every collective; here each one is
written where it is needed (parallel/sharding.py). Ranks are laid out
row-major over (dp, sp, tp), as `Mesh(np.reshape(devices, shape))` lays
out the JAX package's devices.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from . import dist as vdist


@dataclass
class Mesh:
    """shape (dp, sp, tp) over the global `ranks`; `coord` is this
    process's (d, s, t), None when it is not a member. `groups` holds this
    process's groups: 'tp' (same d, s), 'sp' (same d, t), 'dpsp' (same t;
    the ranks a video tensor is gathered over) and 'all' (the mesh); None
    for a group of one rank."""
    shape: tuple
    ranks: tuple
    coord: Optional[tuple]
    groups: dict = field(default_factory=dict)

    @property
    def dp(self) -> int:
        return self.shape[0]

    @property
    def sp(self) -> int:
        return self.shape[1]

    @property
    def tp(self) -> int:
        return self.shape[2]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def member(self) -> bool:
        return self.coord is not None

    @property
    def index(self) -> int:
        """This process's position in the mesh, row-major."""
        d, s, t = self.coord
        return (d * self.sp + s) * self.tp + t

    def group(self, name: str):
        return self.groups.get(name)

    def describe(self) -> str:
        return (f'(dp,sp,tp)={self.shape} ranks {list(self.ranks)}'
                + (f' coord {self.coord}' if self.member else ''))


def make_mesh(shape: Optional[Sequence[int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over (dp, sp, tp) of `ranks` (default: the whole world). The
    default shape puts every rank on sp, as the JAX package's does. Every
    process of the world must call it with the same arguments (the process
    groups are made collectively), members or not."""
    n_world = vdist.world_size()
    ranks = tuple(range(n_world)) if ranks is None else tuple(ranks)
    if shape is None:
        shape = (1, len(ranks), 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3 or int(np.prod(shape)) != len(ranks):
        raise ValueError(f'mesh {shape} != {len(ranks)} ranks')
    if any(r >= n_world for r in ranks):
        raise ValueError(f'ranks {list(ranks)} outside a world of {n_world}')
    grid = np.asarray(ranks).reshape(shape)
    me = vdist.rank()
    hit = np.argwhere(grid == me)
    coord = tuple(int(c) for c in hit[0]) if len(hit) else None
    groups = {}

    def make(name, members):
        members = [int(r) for r in members]
        g = dist.new_group(members) if len(members) > 1 else None
        if me in members:
            groups[name] = g

    if len(ranks) > 1:
        dp, sp, tp = shape
        for d, s in itertools.product(range(dp), range(sp)):
            make('tp', grid[d, s, :])
        for d, t in itertools.product(range(dp), range(tp)):
            make('sp', grid[d, :, t])
        for t in range(tp):
            make('dpsp', grid[:, :, t].reshape(-1))
        make('all', grid.reshape(-1))
    return Mesh(shape=shape, ranks=ranks, coord=coord, groups=groups)
