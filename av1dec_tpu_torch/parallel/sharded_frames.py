"""Frame-sharded decode over a mesh axis.

Port of `av1dec_tpu.parallel.sharded_frames`.  K same-geometry frames
decode one per rank along an axis of the mesh, each through the port's
single-device back half (`DeviceRecon.run`: wavefront scan, deblock,
CDEF on `cdef_frame`, superres and LR), and every rank gathers the K
frames' planes.

The JAX package's `_prep_frames` is not ported: it pads every frame's
lanes, windows and buffers to one shape because `shard_map` runs one
program on uniform shapes.  Ranks of `torch.distributed` each run their
own frame at its own shapes, so they need no such padding; only the
planes they exchange must agree, hence the same-geometry precondition.
"""
from __future__ import annotations

import numpy as np
import torch


def _geometry(dr):
    return (dr.sch.num_planes, tuple(map(tuple, dr.sch.valid_dims)),
            dr.hdr["upscaled_width"], dr.hdr["frame_height"],
            bool(dr.hdr.get("use_superres")))


def decode_frames_sharded(drs, mesh, axis="data", device="cuda"):
    """Decode K = mesh.size(axis) same-geometry frames (DeviceRecon
    objects, the same list on every rank of the line), frame i on the
    rank at index i of `axis`, on `device` (a card unless "cpu" is
    named).  Returns, on every rank, a list (per frame) of host int64
    plane lists, byte-identical to `DeviceRecon.run` of each frame."""
    import torch.distributed as dist

    from av1dec_tpu_torch import resolve_device
    from av1dec_tpu_torch.parallel.dist import wire_device
    dev = resolve_device(device)
    K = mesh.size(axis)
    if len(drs) != K:
        raise ValueError(f"decode_frames_sharded: {len(drs)} frames for "
                         f"{K} ranks on '{axis}': one frame per rank")
    if len({_geometry(dr) for dr in drs}) != 1:
        raise ValueError("decode_frames_sharded: the frames differ in "
                         "geometry")
    mine = drs[mesh.index(axis)].run(dev)
    group = mesh.group(axis)
    wire = wire_device(group, dev)
    out = [[] for _ in range(K)]
    for p in mine:
        part = torch.as_tensor(np.ascontiguousarray(p, np.int32)).to(wire)
        parts = [torch.empty_like(part) for _ in range(K)]
        dist.all_gather(parts, part, group=group)
        for k, q in enumerate(parts):
            out[k].append(q.cpu().numpy().astype(np.int64))
    return out
