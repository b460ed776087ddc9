"""CDEF on the device — whole-frame torch formulation. [SPEC §7.15]

Port of `av1dec_tpu.ops.kernels.cdef`:

- `_directions`: the 8x8 direction search.  The one-hot projection
  runs as a float32 matmul, which is exact: each of the 120 partial sums
  adds at most 8 values in [-128, 127].  The costs use int64
  multiply-and-sum (they reach about 2^30, beyond float32's exact
  range) and are cast back to int32 once the variance is taken;
  `_first_argmax` returns the first maximum, as the spec's strict `>`.
- `_filter_plane`: the plain per-plane filter (12 taps, each a select
  over 8 statically shifted copies of the padded plane).  It is the
  reference of the CUDA kernel and runs for CPU tensors.
- `filter_plane`: the public per-plane filter.  A CUDA tensor goes to
  the hand-written kernel (`csrc/cdef_filter.cu`), a CPU tensor to
  `_filter_plane`; nothing else is accepted.
- `_cdef_core`: variance gating, damping shifts, per-pixel maps and the
  three plane filters of one frame, in plain torch.
- `cdef_frame`: the public CDEF of one frame (the function of
  `_cdef_core`).  A CUDA frame goes to the hand-written kernel
  (`csrc/cdef_frame.cu`: one launch for every plane, direction search
  and gating inside, per-8x8-unit strengths in place of per-pixel
  maps), a CPU frame to `_cdef_core`; nothing else is accepted.

All pixel math is int32, bit-exact with the JAX package.
"""
import ctypes

import numpy as np
import torch

from av1dec_tpu_torch.ops.spec.cdef import (CDEF_VERY_LARGE, DIRECTIONS,
                                            DIV_TABLE)

# one-hot projection matrix, all 8 axes side by side: [64, 8*15]
_PROJ = np.zeros((8, 64, 15), np.int32)
for _i in range(8):
    for _j in range(8):
        for _d, _idx in enumerate([
                _i + _j, _i + (_j >> 1), _i, 3 + _i - (_j >> 1),
                7 + _i - _j, 3 - (_i >> 1) + _j, _j, (_i >> 1) + _j]):
            _PROJ[_d, _i * 8 + _j, _idx] = 1
_PROJ_FLAT = _PROJ.transpose(1, 0, 2).reshape(64, 120)

_DIR_DY = np.array([[d[k][0] for k in range(2)] for d in DIRECTIONS])
_DIR_DX = np.array([[d[k][1] for k in range(2)] for d in DIRECTIONS])
_DIV = np.asarray(DIV_TABLE, np.int64).astype(np.int32)
# 4:2:2 chroma direction remap [SPEC §7.15.3]
_UV_DIR_422 = np.array([7, 0, 2, 4, 5, 6, 6, 6], np.int32)

# launches of the CUDA per-plane filter kernel in this process
launches = 0
# launches of the CUDA frame kernel in this process
frame_launches = 0


def _first_argmax(cost):
    """Index of the first maximum along dim 1 of an int64 [B, 8] tensor
    (cost >= 0): ties go to the lowest index on every backend."""
    d = torch.arange(8, dtype=torch.int64, device=cost.device)
    return ((cost << 3) + (7 - d)).argmax(1)


def _directions(luma, bd):
    """luma [H,W] int32 (H,W multiples of 8) -> (dir, var) [H/8, W/8]
    int32."""
    H, W = luma.shape
    dev = luma.device
    x = (luma.to(torch.int32) >> (bd - 8)) - 128
    blocks = x.reshape(H // 8, 8, W // 8, 8).permute(0, 2, 1, 3) \
        .reshape(-1, 64)
    proj = torch.as_tensor(_PROJ_FLAT, dtype=torch.float32, device=dev)
    partial = (blocks.to(torch.float32) @ proj).round().to(torch.int64) \
        .reshape(-1, 8, 15)
    p2 = partial * partial
    div = torch.as_tensor(_DIV, dtype=torch.int64, device=dev)
    cols = []
    for d in range(8):
        if d in (2, 6):
            c = 105 * p2[:, d, :8].sum(1)
        elif d in (0, 4):
            c = ((p2[:, d, :7] + p2[:, d, 8:15].flip(1))
                 * div[:7]).sum(1) + p2[:, d, 7] * 105
        else:
            c = 105 * p2[:, d, 3:8].sum(1) + \
                ((p2[:, d, :3] + p2[:, d, 8:11].flip(1)) *
                 div[1:6:2]).sum(1)
        cols.append(c)
    cost = torch.stack(cols, 1)
    best = _first_argmax(cost)
    c_best = cost.gather(1, best[:, None])[:, 0]
    c_orth = cost.gather(1, ((best + 4) & 7)[:, None])[:, 0]
    var = (c_best - c_orth) >> 10
    return (best.to(torch.int32).reshape(H // 8, W // 8),
            var.to(torch.int32).reshape(H // 8, W // 8))


def _ilog2(v):
    """floor(log2(max(v,1))) for 0 <= v < 2^13, exactly, in int32."""
    out = torch.zeros_like(v)
    for k in range(1, 13):
        out = out + (v >= (1 << k)).to(torch.int32)
    return out


def _constrain(diff, strength, shift):
    ad = diff.abs()
    return torch.sign(diff) * torch.minimum(
        ad, torch.clamp(strength - (ad >> shift), min=0))


def _filter_plane(plane_arr, pri_px, sec_px, dir_px, pri_shift, sec_shift,
                  apply_px, coeff_shift, pad=None):
    """Plain version of the CDEF plane filter.  All *_px are [H,W]
    int32.  `pad` may be a prebuilt [H+4, W+4] bordered copy (the
    column-sharded path builds it with neighbour halos instead of
    CDEF_VERY_LARGE)."""
    H, W = plane_arr.shape
    x = plane_arr.to(torch.int32)
    if pad is None:
        pad = torch.full((H + 4, W + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                         device=x.device)
        pad[2:H + 2, 2:W + 2] = x
    total = torch.zeros((H, W), dtype=torch.int32, device=x.device)
    mx = x
    mn = x
    odd = ((pri_px >> coeff_shift) & 1) != 0
    pri_tap0 = torch.where(odd, 3, 4).to(torch.int32)
    pri_tap1 = torch.where(odd, 3, 2).to(torch.int32)
    sec_taps = (2, 1)

    def gather(rot, k, sgn):
        """Select among the 8 direction-shifted images, elementwise."""
        out = torch.zeros((H, W), dtype=torch.int32, device=x.device)
        for d in range(8):
            dd = (d + rot) & 7
            y0 = 2 + sgn * int(_DIR_DY[dd, k])
            x0 = 2 + sgn * int(_DIR_DX[dd, k])
            out = torch.where(dir_px == d, pad[y0:y0 + H, x0:x0 + W], out)
        return out

    def tap(p, strength, shift, weight):
        nonlocal total, mx, mn
        valid = (p != CDEF_VERY_LARGE) & (strength > 0)
        total = total + torch.where(
            valid, weight * _constrain(p - x, strength, shift), 0)
        mx = torch.where(valid, torch.maximum(mx, p), mx)
        mn = torch.where(valid, torch.minimum(mn, p), mn)

    for k in range(2):
        tap_p = pri_tap0 if k == 0 else pri_tap1
        for sgn in (1, -1):
            tap(gather(0, k, sgn), pri_px, pri_shift, tap_p)
        for rot in (2, 6):
            for sgn in (1, -1):
                tap(gather(rot, k, sgn), sec_px, sec_shift, sec_taps[k])
    y = x + ((8 + total - (total < 0).to(torch.int32)) >> 4)
    y = torch.minimum(torch.maximum(y, mn), mx)
    return torch.where(apply_px != 0, y, x)


_MAPS = ("pri", "sec", "dir", "pri_shift", "sec_shift", "apply")


def filter_plane(plane_arr, pri_px, sec_px, dir_px, pri_shift, sec_shift,
                 apply_px, coeff_shift, pad=None):
    """CDEF filter of one plane (the function of `_filter_plane`).

    A CUDA plane runs the hand-written kernel and counts one launch in
    `launches`; a CPU plane runs `_filter_plane`.  Every map must lie on
    the plane's device; the kernel takes contiguous int32 [H, W] maps
    and, when given, a contiguous int32 [H+4, W+4] `pad`."""
    global launches
    if plane_arr.device.type == "cpu":
        return _filter_plane(plane_arr, pri_px, sec_px, dir_px, pri_shift,
                             sec_shift, apply_px, coeff_shift, pad)
    if plane_arr.device.type != "cuda":
        raise ValueError(f"filter_plane: unsupported device "
                         f"{plane_arr.device}")
    from av1dec_tpu_torch.ops.kernels.cuda_build import load_kernel
    lib = load_kernel("cdef_filter")
    H, W = plane_arr.shape
    maps = (pri_px, sec_px, dir_px, pri_shift, sec_shift, apply_px)
    for name, m in zip(_MAPS, maps):
        _check(name, m, plane_arr.device, (H, W))
    plane = plane_arr.to(torch.int32).contiguous()
    if pad is not None:
        _check("pad", pad, plane_arr.device, (H + 4, W + 4))
    out = torch.empty((H, W), dtype=torch.int32, device=plane_arr.device)
    stream = torch.cuda.current_stream(plane_arr.device).cuda_stream
    err = lib.cdef_filter_plane(
        ctypes.c_void_p(plane.data_ptr()),
        ctypes.c_void_p(None if pad is None else pad.data_ptr()),
        *[ctypes.c_void_p(m.data_ptr()) for m in maps],
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int(H), ctypes.c_int(W),
        ctypes.c_int(coeff_shift), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cdef_filter_plane launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def _check(name, t, device, shape):
    if t.device != device or t.dtype != torch.int32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"CDEF: {name} must be a contiguous int32 {shape} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _cdef_core(planes, y_pri_u, y_sec_u, uv_pri_u, uv_sec_u,
               bd, damping_y, subx, suby):
    """CDEF of one frame.  `planes`: tuple of [H,W] int32 plane tensors;
    *_u: per-8x8-luma-unit strengths (already gated by `active`, <=0
    where inactive).  Returns the filtered planes (same shapes)."""
    coeff_shift = bd - 8
    luma = planes[0]
    dev = luma.device
    dirs, var = _directions(luma, bd)
    active_pri = y_pri_u > 0

    # luma primary strength: variance adjustment [SPEC §7.15.1]
    v6 = var >> 6
    i_adj = torch.clamp(_ilog2(v6), max=12)
    pri_adj = torch.where(var != 0, (y_pri_u * (4 + i_adj) + 8) >> 4, 0)
    pri_adj = torch.where(active_pri, pri_adj, 0).to(torch.int32)

    def shift_for(strength, damp):
        return torch.clamp(damp - _ilog2(torch.clamp(strength, min=1)),
                           min=0).to(torch.int32)

    def expand(u, ry, rx, H, W):
        uh, uw = u.shape
        return u.to(torch.int32)[:, None, :, None] \
            .expand(uh, ry, uw, rx).reshape(uh * ry, uw * rx)[:H, :W] \
            .contiguous()

    H, W = luma.shape
    apply_y = (pri_adj > 0) | (y_sec_u > 0)
    out = [_filter_plane(
        luma,
        expand(pri_adj, 8, 8, H, W),
        expand(y_sec_u, 8, 8, H, W),
        expand(torch.where(active_pri, dirs, 0), 8, 8, H, W),
        expand(shift_for(pri_adj, damping_y), 8, 8, H, W),
        expand(shift_for(y_sec_u, damping_y), 8, 8, H, W),
        expand(apply_y, 8, 8, H, W), coeff_shift)]

    if len(planes) > 1:
        uvdir = torch.where(uv_pri_u > 0, dirs, 0)
        if subx != suby and subx:
            remap = torch.as_tensor(_UV_DIR_422, device=dev)
            uvdir = torch.where(uv_pri_u > 0, remap[uvdir.long()], 0)
        Hc, Wc = planes[1].shape
        ry, rx = 8 >> suby, 8 >> subx
        apply_uv = (uv_pri_u > 0) | (uv_sec_u > 0)
        args = (expand(uv_pri_u, ry, rx, Hc, Wc),
                expand(uv_sec_u, ry, rx, Hc, Wc),
                expand(uvdir, ry, rx, Hc, Wc),
                expand(shift_for(uv_pri_u, damping_y - 1), ry, rx, Hc, Wc),
                expand(shift_for(uv_sec_u, damping_y - 1), ry, rx, Hc, Wc),
                expand(apply_uv, ry, rx, Hc, Wc))
        for pl in (1, 2):
            out.append(_filter_plane(planes[pl], *args, coeff_shift))
    return tuple(out)


def _rows(p):
    """`p` as int32 rows that the frame kernel copies 16 bytes at a
    time: unit column stride, base and row pitch multiples of 16 bytes.
    The frame buffer's plane views and the deblocked planes are so, and
    are not copied."""
    p = p.to(torch.int32)
    if p.stride(1) != 1 or p.stride(0) < p.shape[1] or p.stride(0) % 4 \
            or p.data_ptr() % 16:
        p = p.clone(memory_format=torch.contiguous_format)
    return p


def cdef_frame(planes, y_pri_u, y_sec_u, uv_pri_u, uv_sec_u, bd, damping,
               subx, suby):
    """CDEF of one frame (the function of `_cdef_core`, same arguments).

    A CUDA frame runs the hand-written frame kernel, one launch for every
    plane, and counts it in `frame_launches`; a CPU frame runs
    `_cdef_core`.  The luma plane is [H, W] with H, W multiples of 8, the
    chroma planes [H >> suby, W >> subx]; the four strengths are
    [H/8, W/8] int32 on the planes' device.  Returns new int32 planes."""
    global frame_launches
    dev = planes[0].device
    if dev.type == "cpu":
        return _cdef_core(planes, y_pri_u, y_sec_u, uv_pri_u, uv_sec_u, bd,
                          damping, subx, suby)
    if dev.type != "cuda":
        raise ValueError(f"cdef_frame: unsupported device {dev}")
    from av1dec_tpu_torch.ops.kernels.cuda_build import load_kernel
    lib = load_kernel("cdef_frame")
    H, W = planes[0].shape
    if H % 8 or W % 8 or len(planes) not in (1, 3):
        raise ValueError(f"cdef_frame: needs 1 or 3 planes and a luma "
                         f"plane of multiples of 8, got {len(planes)} "
                         f"planes, luma {H}x{W}")
    src = [_rows(p) for p in planes]
    for p in src[1:]:
        if p.device != dev or tuple(p.shape) != (H >> suby, W >> subx):
            raise ValueError(f"cdef_frame: chroma must be "
                             f"{(H >> suby, W >> subx)} on {dev}, got "
                             f"{tuple(p.shape)} on {p.device}")
    gates = (y_pri_u, y_sec_u, uv_pri_u, uv_sec_u)
    for name, g in zip(("y_pri", "y_sec", "uv_pri", "uv_sec"), gates):
        _check(name, g, dev, (H // 8, W // 8))
    outs = [torch.empty(p.shape, dtype=torch.int32, device=dev)
            for p in src]
    absent = [None] * (3 - len(src))  # U and V of a mono frame
    err = lib.cdef_frame(
        *[p.data_ptr() for p in src], *absent,
        *[p.stride(0) for p in src], *[0] * len(absent),
        *[o.data_ptr() for o in outs], *absent,
        *[g.data_ptr() for g in gates], H, W, len(src), bd, damping, subx,
        suby, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cdef_frame launch failed: CUDA error {err}")
    frame_launches += 1
    return tuple(outs)


def compute_gates(seq, hdr, plans, n_planes, bd):
    """Host-side per-8x8-unit CDEF strength gating (mi-grid
    bookkeeping).  Returns (y_pri, y_sec, uv_pri, uv_sec, damping,
    subx, suby) host int32 arrays, or None when CDEF is disabled for
    this frame. [SPEC §7.15.1]"""
    c = hdr.get("cdef")
    if not c or hdr.get("coded_lossless") or hdr.get("allow_intrabc"):
        return None
    nstr = 1 << c["bits"]
    if all(c["y_pri"][i] == 0 and c["y_sec"][i] == 0 and
           c["uv_pri"][i] == 0 and c["uv_sec"][i] == 0
           for i in range(nstr)):
        return None
    coeff_shift = bd - 8
    mi_rows, mi_cols = plans.mi_rows, plans.mi_cols
    skip = plans.grid("skip").astype(np.int64)
    cdef_mi = plans.grid("cdef").astype(np.int64)
    subx = seq.get("subsampling_x", 1) if n_planes > 1 else 0
    suby = seq.get("subsampling_y", 1) if n_planes > 1 else 0

    uR, uC = (mi_rows + 1) // 2, (mi_cols + 1) // 2
    r1 = np.minimum(np.arange(uR) * 2 + 1, mi_rows - 1)
    c1 = np.minimum(np.arange(uC) * 2 + 1, mi_cols - 1)
    r0 = np.arange(uR) * 2
    c0 = np.arange(uC) * 2
    unit_skip = skip[np.ix_(r0, c0)] & skip[np.ix_(r0, c1)] & \
        skip[np.ix_(r1, c0)] & skip[np.ix_(r1, c1)]
    idx = cdef_mi[np.ix_(r0, c0)]
    active = (unit_skip == 0) & (idx >= 0)
    idxc = np.clip(idx, 0, nstr - 1)

    def gate(tbl):
        u = np.asarray(tbl, np.int32)[idxc] << coeff_shift
        return np.where(active, u, 0).astype(np.int32)

    return (gate(c["y_pri"]), gate(c["y_sec"]), gate(c["uv_pri"]),
            gate(c["uv_sec"]), c["damping"] + coeff_shift, subx, suby)
