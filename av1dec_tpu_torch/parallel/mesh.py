"""The (data, space) mesh of the decode pipeline over the ranks of a
`torch.distributed` group.

Port of `av1dec_tpu.parallel.mesh`.  Axes:
  data  - independent work (frames, GOPs)
  space - column shards of a frame; neighbours exchange loop-filter
          halos (`halo.py`)
Rank r sits at (r // space, r % space).  Each axis has one subgroup per
line of the mesh (`dist.new_group`); `init_device_mesh` is not used
because it pins one rank per card, and the ranks of one card share it
under gloo.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int          # size of the data axis
    space: int         # size of the space axis
    data_index: int    # this rank's coordinate on the data axis
    space_index: int   # this rank's coordinate on the space axis
    space_ranks: tuple  # global ranks of this rank's space line, in order
    data_group: object   # the process group of this rank's data line
    space_group: object  # the process group of space_ranks

    def size(self, axis):
        return getattr(self, axis)

    def index(self, axis):
        return getattr(self, axis + "_index")

    def group(self, axis):
        return getattr(self, axis + "_group")


def make_mesh(world_size=None, data=None):
    """Factor the first `world_size` ranks (default: all) into
    (data, space): `data` defaults to the largest power of two that
    divides the count and is at most its square root, as the JAX
    package's `make_mesh`.  Every rank of the group must call it (the
    subgroups are made collectively); a rank outside the first
    `world_size` gets None."""
    import torch.distributed as dist
    world = dist.get_world_size()
    n = world_size or world
    if not 0 < n <= world:
        raise ValueError(f"make_mesh: {n} ranks of a group of {world}")
    if data is None:
        data = 1
        while data * 2 <= math.isqrt(n) and n % (data * 2) == 0:
            data *= 2
    if n % data:
        raise ValueError(f"make_mesh: data axis {data} does not divide "
                         f"{n} ranks")
    space = n // data
    rank = dist.get_rank()
    mine = {}
    # every rank makes every subgroup, in the same order
    for d in range(data):
        ranks = tuple(d * space + s for s in range(space))
        g = dist.new_group(list(ranks))
        if rank in ranks:
            mine["space"] = (ranks, g)
    for s in range(space):
        ranks = tuple(d * space + s for d in range(data))
        g = dist.new_group(list(ranks))
        if rank in ranks:
            mine["data"] = (ranks, g)
    if rank >= n:
        return None
    return Mesh(data=data, space=space, data_index=rank // space,
                space_index=rank % space, space_ranks=mine["space"][0],
                data_group=mine["data"][1], space_group=mine["space"][1])
