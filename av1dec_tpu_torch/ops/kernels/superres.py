"""Superres upscale on the device [SPEC §7.16].

Port of `av1dec_tpu.pipeline.device_recon._superres_dev`: per plane, the
horizontal 64-phase 8-tap upscale as one gather of precomputed clamped
tap columns and 8 multiply-adds, from the host-built per-plane
(cols [dw, 8], taps [dw, 8]) tables (`DeviceRecon._superres_args`).
Twin of `ops.spec.superres.upscale_plane_rows`.

`superres_planes` upscales every plane it is given (the final planes
and, when loop restoration reads them, the pre-CDEF planes).  Planes on
a card run the hand-written kernel `csrc/superres.cu`, one launch for
every plane (counted in `launches`); planes on the CPU run the plain
version `_superres_plain`.  All int32, bit-exact with the JAX package.
"""
import torch

from av1dec_tpu_torch.ops.kernels.cuda_build import (launch, param_list,
                                                     param_names)

# launches of the CUDA superres kernel in this process (one a frame)
launches = 0
MAX_PLANES = 6  # the final planes and the pre-CDEF planes
# the kernel's int64 parameter array (`csrc/superres.cu`, enum Param): the
# ints, then per plane its source, size, output and tables
_PARAMS = param_names(["bd", "nplanes"],
                      ("src", "src_stride", "h", "w", "out", "dw", "cols",
                       "taps"), MAX_PLANES)


def superres_planes(planes, sr_args, bd):
    """Upscale planes[i] with sr_args[i] = (cols, taps), int32 [dw, 8]
    tensors on the planes' device.  Planes on a card run the kernel,
    planes on the CPU the plain version."""
    dev = planes[0].device
    if dev.type == "cpu":
        return _superres_plain(planes, sr_args, bd)
    if dev.type == "cuda":
        return _superres_kernel(planes, sr_args, bd)
    raise ValueError(f"superres_planes: unsupported device {dev}")


def _superres_plain(planes, sr_args, bd):
    """The plain version, on any device (`superres_planes`' arguments)."""
    outs = []
    for p, (cols, taps) in zip(planes, sr_args):
        src = p.to(torch.int32)
        g = src[:, cols.reshape(-1).long()].reshape(
            (src.shape[0],) + tuple(cols.shape))            # [H, dw, 8]
        acc = (g * taps[None, :, :]).sum(-1, dtype=torch.int32)
        outs.append(((acc + 64) >> 7).clamp(0, (1 << bd) - 1))
    return outs


def _superres_kernel(planes, sr_args, bd):
    """Every plane on the card in one `superres_frame` launch, on the
    planes' device and its current stream, counted in `launches`.  The
    planes are read in place through their row stride.  Raises on inputs
    the kernel does not take or a failed launch."""
    global launches
    dev = planes[0].device
    if not 1 <= len(planes) <= MAX_PLANES or len(sr_args) < len(planes) or \
            bd not in (8, 10, 12):
        raise ValueError(f"superres_planes: {len(planes)} planes at {bd} "
                         f"bits, the kernel takes 1 to {MAX_PLANES} at 8, "
                         f"10 or 12, each with its tables")
    for p, (cols, taps) in zip(planes, sr_args):
        if p.device != dev or p.dtype != torch.int32 or p.ndim != 2 or \
                p.stride(1) != 1 or p.numel() == 0:
            raise ValueError(f"superres_planes: planes must be non-empty "
                             f"int32 [H, W] rows on {dev}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
        for t in (cols, taps):
            if t.device != dev or t.dtype != torch.int32 or t.ndim != 2 or \
                    t.shape != cols.shape or t.shape[1] != 8 or \
                    not t.is_contiguous():
                raise ValueError(f"superres_planes: cols and taps must be "
                                 f"contiguous int32 [dw, 8] on {dev}")
    shapes = [(p.shape[0], cols.shape[0])
              for p, (cols, _) in zip(planes, sr_args)]
    sizes = [h * dw for h, dw in shapes]
    outs = [o.view(s) for s, o in zip(shapes, torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes))]
    launch("superres", "superres_frame", dev,
           _params(bd, planes, sr_args, outs), len(planes))
    launches += 1
    return outs


def _params(bd, planes, sr_args, outs):
    """The kernel's parameters in `_PARAMS` order: tensors where it takes
    a pointer, ints; a plane the call does not have is 0 throughout."""
    params = dict(bd=bd, nplanes=len(planes))
    for i, (p, (cols, taps), o) in enumerate(zip(planes, sr_args, outs)):
        params.update({f"src{i}": p, f"src_stride{i}": p.stride(0),
                       f"h{i}": p.shape[0], f"w{i}": p.shape[1],
                       f"out{i}": o, f"dw{i}": o.shape[1],
                       f"cols{i}": cols, f"taps{i}": taps})
    return param_list(_PARAMS, params)
