"""Column-sharded CDEF over the mesh's `space` axis. [SPEC §7.15]

Port of `av1dec_tpu.parallel.sharded_cdef`.  CDEF reads a +-2 pixel
neighbourhood, so a plane sharded by columns needs 2 halo columns from
each space neighbour (`halo.exchange_halo_cols_fill`).  The direction
search and the per-unit strengths are local to each 8x8-unit-aligned
shard; each shard is filtered by `cdef.cdef_shard` from the bordered
copies `_mk_pad` builds: `csrc/cdef_filter.cu`, one launch for every
plane, on a card, its plain version `_cdef_shard_core` on the CPU.  The
result equals the whole-frame CDEF byte for byte
(tests/test_torch_distributed.py; `chip_smoke.py` phase 7 on the card).

`cdef_local` is the same CDEF over the devices of one process, with no
process group (the JAX package's `DeviceRecon._cdef_device` over a local
`("space",)` mesh): the shards' halo columns are read from the whole
plane in memory, and each shard is filtered on its own device, which
may repeat (one card, or the CPU, holding several shards).
`pipeline/device_recon.DeviceRecon` runs it when
`DecoderConfig.space_shards > 1`.
"""
from __future__ import annotations

import torch

from av1dec_tpu_torch.ops.kernels import cdef as C
from av1dec_tpu_torch.ops.spec.cdef import CDEF_VERY_LARGE
from av1dec_tpu_torch.parallel.halo import exchange_halo_cols_fill

# frames filtered by `cdef_local` in this process
local_frames = 0


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


def _check_widths(planes, units, subx, n):
    """Every plane is `units` 8x8-luma units wide and splits into n
    shards of whole units."""
    for pl, p in enumerate(planes):
        step = 8 >> (subx if pl else 0)
        if p.shape[1] % (step * n) or units * step != p.shape[1]:
            raise ValueError(
                f"cdef_sharded: plane {pl} width {p.shape[1]} is not "
                f"divisible by {step} * {n} space shards, or not {units} "
                f"units of {step} columns")


def cdef_sharded(planes, gates, bd, mesh):
    """CDEF of one frame with its plane columns sharded over the mesh's
    `space` axis; SPMD: every rank of the space line calls it with the
    same arguments.

    planes: [H, W] int32 tensors (or arrays), whole on every rank, on
    the device to filter on; every plane must lie on the 8x8-unit grid
    (units * (8 >> subx) == W) and split into n_space shards of whole
    units (a luma width divisible by 8 * n_space).  gates:
    `compute_gates` output (y_pri, y_sec, uv_pri, uv_sec, damping, subx,
    suby), whole.  Returns the filtered whole planes on every rank, on
    the planes' device, byte-equal to `_cdef_core` of the whole frame."""
    y_pri, y_sec, uv_pri, uv_sec, damping, subx, suby = gates
    n, s = mesh.space, mesh.space_index
    planes = [torch.as_tensor(p).to(torch.int32) for p in planes]
    dev = planes[0].device
    units = torch.as_tensor(y_pri).shape[1]
    _check_widths(planes, units, subx, n)
    uw = units // n
    strengths = [torch.as_tensor(g).to(device=dev, dtype=torch.int32)
                 [:, s * uw:(s + 1) * uw].contiguous()
                 for g in (y_pri, y_sec, uv_pri, uv_sec)]
    pads = []
    for p in planes:
        w = p.shape[1] // n
        pads.append(_mk_pad(p[:, s * w:(s + 1) * w].contiguous(), mesh))
    out = C.cdef_shard(tuple(pads), *strengths, bd, damping, subx, suby)
    return tuple(_gather_cols(o, mesh) for o in out)


def local_devices(device):
    """The devices of this process that the shards of a frame on
    `device` run on (`DeviceRecon._cdef_device`): every card of the
    process for a card, the CPU itself for the CPU.  A test stands in
    another list here (the CPU or one card repeated) to run the shard
    path on one device."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _local_pad(plane, s, n):
    """Bordered [H+4, w+4] copy of column shard `s` of `n` of a whole
    plane: 2 columns of each neighbouring shard, read from the plane
    (CDEF_VERY_LARGE at the frame's edges), and CDEF_VERY_LARGE rows
    above and below: what `_mk_pad` builds with a halo exchange."""
    H, W = plane.shape
    w = W // n
    pad = torch.full((H + 4, w + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                     device=plane.device)
    lo, hi = max(0, s * w - 2), min(W, (s + 1) * w + 2)
    c0 = 2 - (s * w - lo)
    pad[2:H + 2, c0:c0 + hi - lo] = plane[:, lo:hi]
    return pad


def cdef_local(planes, gates, bd, devices):
    """CDEF of one frame with its plane columns cut into len(devices)
    shards, shard s filtered on devices[s] (`cdef.cdef_shard`: one launch
    of the `cdef_filter.cu` kernel on a card, its plain version on the
    CPU) in this process.  planes: whole [H, W] int32 tensors on one device,
    on the 8x8-unit grid, the luma width divisible by 8 * len(devices);
    gates: `compute_gates` output.  Returns the whole filtered planes on
    the planes' device, byte-equal to `_cdef_core` of the whole frame."""
    global local_frames
    y_pri, y_sec, uv_pri, uv_sec, damping, subx, suby = gates
    n = len(devices)
    planes = [torch.as_tensor(p).to(torch.int32) for p in planes]
    home = planes[0].device
    units = torch.as_tensor(y_pri).shape[1]
    _check_widths(planes, units, subx, n)
    uw = units // n
    outs = []
    for s, dev in enumerate(devices):
        dev = torch.device(dev)
        strengths = [torch.as_tensor(g).to(dtype=torch.int32)
                     [:, s * uw:(s + 1) * uw].to(dev).contiguous()
                     for g in (y_pri, y_sec, uv_pri, uv_sec)]
        pads = tuple(_local_pad(p, s, n).to(dev) for p in planes)
        outs.append(C.cdef_shard(pads, *strengths, bd, damping, subx,
                                 suby))
    local_frames += 1
    return tuple(torch.cat([o[pl].to(home) for o in outs], dim=1)
                 for pl in range(len(planes)))
