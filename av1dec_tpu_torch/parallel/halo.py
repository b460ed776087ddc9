"""Column halo exchange for column-sharded frame filtering.

Port of `av1dec_tpu.parallel.halo`.  Loop filters read a bounded
neighbourhood (CDEF +-2 pixels), so a plane sharded by columns over the
mesh's `space` axis needs `halo` columns from each neighbour.  They move
point to point between space neighbours only (`batch_isend_irecv`); the
outer ends of the axis are edge-replicated or filled.  Under NCCL the
halo columns stay on the card; under gloo they go through CPU tensors.
The result lies on the block's device either way.
"""
from __future__ import annotations

import torch


def _from_neighbours(block, halo, mesh):
    """(columns from the left neighbour, from the right neighbour), each
    [H, halo] on the block's device, or None at an end of the axis."""
    import torch.distributed as dist

    from av1dec_tpu_torch.parallel.dist import wire_device
    i, ranks, group = mesh.space_index, mesh.space_ranks, mesh.space_group
    wire = wire_device(group, block.device)
    ops, got = [], []
    for peer, edge in ((i - 1, block[:, :halo]), (i + 1, block[:, -halo:])):
        if not 0 <= peer < len(ranks):
            got.append(None)
            continue
        recv = torch.empty((block.shape[0], halo), dtype=block.dtype,
                           device=wire)
        ops += [dist.P2POp(dist.isend, edge.to(wire).contiguous(),
                           ranks[peer], group),
                dist.P2POp(dist.irecv, recv, ranks[peer], group)]
        got.append(recv)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [None if g is None else g.to(block.device) for g in got]


def exchange_halo_cols(block, halo, mesh):
    """block: [H, W_shard], this rank's shard.  Returns
    [H, W_shard + 2*halo] with the neighbours' columns attached,
    edge-replicated at the outer ends of the space axis."""
    left, right = _from_neighbours(block, halo, mesh)
    if left is None:
        left = block[:, :1].expand(-1, halo)
    if right is None:
        right = block[:, -1:].expand(-1, halo)
    return torch.cat([left, block, right], dim=1)


def exchange_halo_cols_fill(block, halo, fill, mesh):
    """Like exchange_halo_cols, but the outer ends of the space axis get
    the constant `fill` (CDEF's out-of-frame CDEF_VERY_LARGE)."""
    left, right = _from_neighbours(block, halo, mesh)
    edge = torch.full((block.shape[0], halo), fill, dtype=block.dtype,
                      device=block.device)
    return torch.cat([edge if left is None else left, block,
                      edge if right is None else right], dim=1)
