"""Loop restoration on the device — Wiener filter, whole-plane torch.
[SPEC §7.17.4]

Port of `av1dec_tpu.ops.kernels.lr`: the 7-tap separable Wiener filter
as whole-plane passes with per-pixel taps gathered from the per-unit
coefficient maps.  LR's stripe-boundary reads (each 64-luma-row stripe
reads at most 2 rows above/below itself, from the deblocked pre-CDEF
frame) become 7 per-output-row gathers: per vertical tap, the
stripe-clamped source row is picked from the right plane (post- or
pre-CDEF), with indices and inside-stripe masks precomputed on the host
(`DeviceRecon._lr_wiener_args`), and filtered horizontally with the
taps of the output row's restoration unit, as `ops/spec/lr.lr_frame`
filters each unit's window with that unit's taps.  (The JAX pass
filters each source row with its own unit's taps, which differs from
the spec on the two rows on either side of a chroma unit-row
boundary.)  Each distinct (source plane, source row, unit row) is
filtered horizontally once: about one pass over the plane, plus the
rows near stripe and unit-row boundaries.  Frames with a self-guided
unit keep the host LR tail (`pipeline/device_recon.py` `finish_host`).

`lr_wiener_planes` filters every Wiener plane of a frame.  Planes on a
card run the hand-written kernel `csrc/wiener.cu`, one launch for every
plane (counted in `launches`), a block a tile whose distinct keys' rows
it filters horizontally once, in shared memory; planes on the CPU run
the plain version `_wiener_plain`, `wiener_plane` a plane.
"""
import torch

from av1dec_tpu_torch.ops.kernels.cuda_build import (launch, param_list,
                                                     param_names)

# launches of the CUDA Wiener kernel in this process (one a frame)
launches = 0
MAX_PLANES = 3
# the argument tuple of a plane (`DeviceRecon._lr_wiener_args`)
ARGS = ("uy", "ux", "tv", "th", "act", "vr", "inside")
# the kernel's int64 parameter array (`csrc/wiener.cu`, enum Param): the
# ints, then per plane its planes, output, size, arguments and unit grid
_PARAMS = param_names(["bd", "nplanes"],
                      ("cdef", "cdef_stride", "pre", "pre_stride", "out",
                       "h", "w") + ARGS + ("ur", "uc"), MAX_PLANES)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def wiener_plane(cdef_p, pre_p, args, bd):
    """One plane.  args (int32 tensors, `inside` bool, on the planes'
    device):
      uy [H], ux [W]      — unit row/col index per pixel (sentinel row/
                            col beyond the crop points at inactive
                            padding entries)
      tv, th [UR, UC, 7]  — per-unit vertical/horizontal taps
      act [UR, UC]        — unit active (Wiener) flags
      vr [7, H]           — stripe-clamped source row per (tap, row)
      inside [7, H]       — True: row from cdef; False: from pre
    """
    uy, ux, tv, th, act, vr, inside = args
    H, W = cdef_p.shape
    r0 = 5 if bd == 12 else 3
    r1 = 9 if bd == 12 else 11
    off0 = 1 << (bd + 6)
    lim = (1 << (bd + 1 + 7 - r0)) - 1
    uy, ux = uy.long(), ux.long()

    tv_px = tv[uy][:, ux]                      # [H, W, 7]

    def pad(src):
        src = src.to(torch.int32)
        return torch.cat([src[:, :1].expand(H, 3), src,
                          src[:, -1:].expand(H, 3)], dim=1)

    # the source row of vertical tap k is filtered horizontally with the
    # taps of the OUTPUT row's unit: near a unit-row boundary the clamped
    # rows belong to the next unit, whose taps differ.  Key each (tap,
    # output row) by (plane, source row, output unit row) and filter
    # each distinct key once.
    UR = th.shape[0]
    src_row = (~inside).long() * H + vr.long()         # [7, H] into z
    keys, inv = torch.unique(src_row * UR + uy, return_inverse=True)
    z = torch.cat([pad(cdef_p), pad(pre_p)])[keys // UR]
    th_k = th[keys % UR][:, ux]                        # [K, W, 7]
    h = torch.full((keys.numel(), W), off0, dtype=torch.int32,
                   device=cdef_p.device)
    for j in range(7):
        h = h + th_k[:, :, j] * z[:, j:j + W]
    h = _round2(h, r0).clamp(0, lim)
    acc = torch.full((H, W), -(1 << (bd + r1 - 1)), dtype=torch.int32,
                     device=cdef_p.device)
    for k in range(7):
        acc = acc + tv_px[:, :, k] * h[inv[k]]
    out = _round2(acc, r1).clamp(0, (1 << bd) - 1)
    act_px = act[uy][:, ux] != 0
    return torch.where(act_px, out, cdef_p.to(torch.int32))


def lr_wiener_planes(planes, pre_planes, lr_args, bd):
    """All planes; lr_args[p] is None for planes without restoration.
    The planes and pre-CDEF planes hold pixels in [0, 2^bd) (the kernel
    keeps them as int16).  Planes on a card run the kernel, planes on the
    CPU the plain version."""
    dev = planes[0].device
    if dev.type == "cpu":
        return _wiener_plain(planes, pre_planes, lr_args, bd)
    if dev.type == "cuda":
        return _wiener_kernel(planes, pre_planes, lr_args, bd)
    raise ValueError(f"lr_wiener_planes: unsupported device {dev}")


def _wiener_plain(planes, pre_planes, lr_args, bd):
    """The plain version: `wiener_plane` on each plane with arguments, on
    any device (`lr_wiener_planes`' arguments)."""
    outs = []
    for p, (plane, pre) in enumerate(zip(planes, pre_planes)):
        a = lr_args[p]
        outs.append(plane if a is None
                    else wiener_plane(plane, pre, a, bd))
    return outs


def _wiener_kernel(planes, pre_planes, lr_args, bd):
    """Every plane with arguments on the card in one `wiener_frame`
    launch, on the planes' device and its current stream, counted in
    `launches`; the others are returned as they are.  The planes are
    read in place through their row stride.  Raises on inputs the kernel
    does not take or a failed launch."""
    global launches
    dev = planes[0].device
    todo = [p for p, a in enumerate(lr_args) if a is not None]
    if not todo:
        return list(planes)
    if bd not in (8, 10, 12) or len(todo) > MAX_PLANES:
        raise ValueError(f"lr_wiener_planes: {len(todo)} planes at {bd} "
                         f"bits, the kernel takes up to {MAX_PLANES} at 8, "
                         f"10 or 12")
    for p in todo:
        H, W = planes[p].shape
        UR, UC = lr_args[p][4].shape
        shapes = dict(uy=(H,), ux=(W,), tv=(UR, UC, 7), th=(UR, UC, 7),
                      act=(UR, UC), vr=(7, H), inside=(7, H))
        for t in (planes[p], pre_planes[p]):
            if t.device != dev or t.dtype != torch.int32 or \
                    t.shape != (H, W) or t.stride(1) != 1:
                raise ValueError(f"lr_wiener_planes: plane {p} must be "
                                 f"int32 [H, W] rows on {dev}, its pre-CDEF "
                                 f"plane too")
        for name, t in zip(ARGS, lr_args[p]):
            want = torch.bool if name == "inside" else torch.int32
            if t.device != dev or t.dtype != want or \
                    tuple(t.shape) != shapes[name] or not t.is_contiguous():
                raise ValueError(f"lr_wiener_planes: {name} of plane {p} "
                                 f"must be contiguous {want} "
                                 f"{list(shapes[name])} on {dev}")
    sizes = [planes[p].numel() for p in todo]
    outs = [o.view(planes[p].shape) for p, o in zip(
        todo, torch.empty(sum(sizes), dtype=torch.int32,
                          device=dev).split(sizes))]
    launch("wiener", "wiener_frame", dev,
           _params(bd, [(planes[p], pre_planes[p], o, lr_args[p])
                        for p, o in zip(todo, outs)]), len(todo))
    launches += 1
    result = list(planes)
    for p, o in zip(todo, outs):
        result[p] = o
    return result


def _params(bd, items):
    """The kernel's parameters in `_PARAMS` order for (plane, pre-CDEF
    plane, output, arguments) items: tensors where it takes a pointer,
    ints; a plane the frame does not have is 0 throughout."""
    params = dict(bd=bd, nplanes=len(items))
    for i, (cdef_p, pre_p, out, args) in enumerate(items):
        params.update({f"cdef{i}": cdef_p, f"cdef_stride{i}": cdef_p.stride(0),
                       f"pre{i}": pre_p, f"pre_stride{i}": pre_p.stride(0),
                       f"out{i}": out, f"h{i}": cdef_p.shape[0],
                       f"w{i}": cdef_p.shape[1], f"ur{i}": args[4].shape[0],
                       f"uc{i}": args[4].shape[1]})
        params.update({f"{k}{i}": t for k, t in zip(ARGS, args)})
    return param_list(_PARAMS, params)
