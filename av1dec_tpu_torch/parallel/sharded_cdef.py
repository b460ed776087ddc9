"""Column-sharded CDEF over the mesh's `space` axis. [SPEC §7.15]

Port of `av1dec_tpu.parallel.sharded_cdef`.  CDEF reads a +-2 pixel
neighbourhood, so a plane sharded by columns needs 2 halo columns from
each space neighbour (`halo.exchange_halo_cols_fill`).  The direction
search and the per-unit strengths are local to each 8x8-unit-aligned
shard; each shard's planes are filtered by `filter_plane` on the border
`_mk_pad` builds: `csrc/cdef_filter.cu` on a card, `_filter_plane` on
the CPU.  The result equals the whole-frame CDEF byte for byte
(tests/test_torch_distributed.py; `chip_smoke.py` phase 7 on the card).
"""
from __future__ import annotations

import torch

from av1dec_tpu_torch.ops.kernels import cdef as C
from av1dec_tpu_torch.ops.spec.cdef import CDEF_VERY_LARGE
from av1dec_tpu_torch.parallel.halo import exchange_halo_cols_fill


def _mk_pad(plane, mesh):
    """Bordered [H+4, W+4] copy of a shard: left and right halo columns
    from the space neighbours (CDEF_VERY_LARGE at the frame's edges),
    CDEF_VERY_LARGE rows above and below (rows are not sharded)."""
    ext = exchange_halo_cols_fill(plane.to(torch.int32), 2,
                                  CDEF_VERY_LARGE, mesh)
    rows = torch.full((2, ext.shape[1]), CDEF_VERY_LARGE,
                      dtype=torch.int32, device=ext.device)
    return torch.cat([rows, ext, rows], dim=0)


def _gather_cols(shard, mesh):
    """The whole plane from every rank's column shard, on the shard's
    device (through CPU tensors under gloo)."""
    import torch.distributed as dist

    from av1dec_tpu_torch.parallel.dist import wire_device
    part = shard.to(wire_device(mesh.space_group, shard.device)).contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.space)]
    dist.all_gather(parts, part, group=mesh.space_group)
    return torch.cat(parts, dim=1).to(shard.device)


def cdef_sharded(planes, gates, bd, mesh):
    """CDEF of one frame with its plane columns sharded over the mesh's
    `space` axis; SPMD: every rank of the space line calls it with the
    same arguments.

    planes: [H, W] int32 tensors (or arrays), whole on every rank, on
    the device to filter on; every W must be divisible by 8 * n_space
    and lie on the 8x8-unit grid (units * (8 >> subx) == W).  gates:
    `compute_gates` output (y_pri, y_sec, uv_pri, uv_sec, damping, subx,
    suby), whole.  Returns the filtered whole planes on every rank, on
    the planes' device, byte-equal to `_cdef_core` of the whole frame."""
    y_pri, y_sec, uv_pri, uv_sec, damping, subx, suby = gates
    n, s = mesh.space, mesh.space_index
    planes = [torch.as_tensor(p).to(torch.int32) for p in planes]
    dev = planes[0].device
    units = torch.as_tensor(y_pri).shape[1]
    for pl, p in enumerate(planes):
        step = 8 >> (subx if pl else 0)
        if p.shape[1] % (8 * n) or units * step != p.shape[1]:
            raise ValueError(
                f"cdef_sharded: plane {pl} width {p.shape[1]} is not "
                f"divisible by 8 * {n} space shards, or not {units} units "
                f"of {step} columns")
    uw = units // n
    strengths = [torch.as_tensor(g).to(device=dev, dtype=torch.int32)
                 [:, s * uw:(s + 1) * uw].contiguous()
                 for g in (y_pri, y_sec, uv_pri, uv_sec)]
    shards = []
    for p in planes:
        w = p.shape[1] // n
        shards.append(p[:, s * w:(s + 1) * w].contiguous())
    out = C._cdef_core(tuple(shards), *strengths, bd, damping, subx, suby,
                       mk_pad=lambda p: _mk_pad(p, mesh))
    return tuple(_gather_cols(o, mesh) for o in out)
