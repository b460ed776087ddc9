"""Deblocking loop filter on the device. [SPEC §7.14]

Port of `av1dec_tpu.ops.kernels.deblock`.  Within one pass (all
vertical edges, then all horizontal edges) the edge filters are
independent (an edge's taps never read pixels another same-pass edge
writes), so each pass is one data-parallel computation over an
[H, W/4] edge lattice.

`deblock_planes` filters every plane of a frame.  Planes on a card run
the hand-written kernel `csrc/deblock.cu`, both passes of every plane in
one launch a frame (counted in `launches`), a block a tile with the
intermediate plane in shared memory; planes on the CPU run the plain
version `_deblock_plain`, whole-plane torch passes:

- the 14 edge-crossing taps p6..q6 are 14 strided slices of the
  zero-padded plane;
- masks and filters evaluate elementwise over the lattice;
- written pixels are recombined by shifts and where() (the last writer
  in a fixed order wins);
- the horizontal pass runs the same code on the transposed plane.

Edge decisions (filter length and level) come from the host as dense
per-4x4-cell maps (`ops.spec.deblock.build_deblock_maps`).  All int32,
bit-exact with the JAX package.
"""
import torch

from av1dec_tpu_torch.ops.kernels.cuda_build import (launch, param_list,
                                                     param_names)

# launches of the CUDA deblock kernel in this process (one a frame)
launches = 0
MAX_PLANES = 3
# the kernel's int64 parameter array (`csrc/deblock.cu`, enum Param): the
# frame's ints, then per plane its input, output, size and the cell maps
# of its vertical (_v) and horizontal (_h) edges
_PARAMS = param_names(["sharp", "bd", "nplanes"],
                      ("src", "src_stride", "dst", "dst_stride", "h", "w",
                       "flen_v", "lvl_v", "n4_v", "k4_v", "flen_h", "lvl_h",
                       "n4_h", "k4_h"), MAX_PLANES)


def _thresholds(lvl, sharpness):
    """(limit, blimit, thresh) from the edge filter level map.
    [SPEC §7.14.4]; `sharpness` is the frame's int."""
    shift = (1 if sharpness > 0 else 0) + (1 if sharpness > 4 else 0)
    limit = lvl >> shift
    if sharpness > 0:
        limit = limit.clamp(max=9 - sharpness)
    limit = limit.clamp(min=1)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    return limit, blimit, thresh


def _filter_edges(p, q, length, limit, blimit, thresh, bd):
    """Edge filters over the lattice [SPEC §7.14.6].  p, q: lists of 7
    tensors (p[0]=p0 adjacent .. p[6]=p6), all [H, K] int32.  Returns
    (outp, outq, wrote_p, wrote_q): new values and per-tap written
    masks."""
    F = 1 << (bd - 8)
    limit = limit * F
    blimit = blimit * F
    thresh = thresh * F

    def ad(a, b):
        return (a - b).abs()

    m = (ad(p[1], p[0]) <= limit) & (ad(q[1], q[0]) <= limit) & \
        (ad(p[0], q[0]) * 2 + ad(p[1], q[1]) // 2 <= blimit)
    m6 = m & (ad(p[2], p[1]) <= limit) & (ad(q[2], q[1]) <= limit)
    m8 = m6 & (ad(p[3], p[2]) <= limit) & (ad(q[3], q[2]) <= limit)
    mask = torch.where(length == 4, m,
                       torch.where(length == 6, m6, m8)) & (length > 0)

    flat6 = (ad(p[1], p[0]) <= F) & (ad(q[1], q[0]) <= F) & \
            (ad(p[2], p[0]) <= F) & (ad(q[2], q[0]) <= F)
    flat8 = flat6 & (ad(p[3], p[0]) <= F) & (ad(q[3], q[0]) <= F)
    flat2 = (ad(p[4], p[0]) <= F) & (ad(q[4], q[0]) <= F) & \
            (ad(p[5], p[0]) <= F) & (ad(q[5], q[0]) <= F) & \
            (ad(p[6], p[0]) <= F) & (ad(q[6], q[0]) <= F)

    def rnd(x, b):
        return (x + (1 << (b - 1))) >> b

    outp = list(p)
    outq = list(q)

    # wide 13-tap (length 14, luma) [SPEC §7.14.6.4]
    w14 = mask & (length == 14) & flat8 & flat2
    S = [p[6], p[5], p[4], p[3], p[2], p[1], p[0],
         q[0], q[1], q[2], q[3], q[4], q[5], q[6]]

    def wide(i):
        acc = S[min(max(i - 1, 0), 13)] + S[i] + S[min(max(i + 1, 0), 13)]
        for j in range(i - 6, i + 7):
            acc = acc + S[min(max(j, 0), 13)]
        return rnd(acc, 4)

    for i in range(6):
        outp[i] = torch.where(w14, wide(6 - i), outp[i])
        outq[i] = torch.where(w14, wide(7 + i), outq[i])

    # 7-tap (length 8)
    w8 = mask & (length >= 8) & flat8 & ~w14
    o2 = rnd(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0], 3)
    o1 = rnd(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1], 3)
    o0 = rnd(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2], 3)
    u0 = rnd(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3], 3)
    u1 = rnd(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2, 3)
    u2 = rnd(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3, 3)
    for i, v in enumerate((o0, o1, o2)):
        outp[i] = torch.where(w8, v, outp[i])
    for i, v in enumerate((u0, u1, u2)):
        outq[i] = torch.where(w8, v, outq[i])

    # 5-tap (length 6, chroma)
    w6 = mask & (length == 6) & flat6
    o1 = rnd(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0], 3)
    o0 = rnd(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1], 3)
    u0 = rnd(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2], 3)
    u1 = rnd(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3, 3)
    for i, v in enumerate((o0, o1)):
        outp[i] = torch.where(w6, v, outp[i])
    for i, v in enumerate((u0, u1)):
        outq[i] = torch.where(w6, v, outq[i])

    # narrow 4-tap with hev
    w4 = mask & ~w14 & ~w8 & ~w6
    half = 128 * F
    lo, hi = -half, half - 1

    def sc(x):
        return x.clamp(lo, hi)

    hev = (ad(p[1], p[0]) > thresh) | (ad(q[1], q[0]) > thresh)
    ps1, ps0 = p[1] - half, p[0] - half
    qs0, qs1 = q[0] - half, q[1] - half
    a = sc(torch.where(hev, sc(ps1 - qs1), 0) + 3 * (qs0 - ps0))
    f1 = sc(a + 4) >> 3
    f2 = sc(a + 3) >> 3
    top = (1 << bd) - 1
    n_q0 = (sc(qs0 - f1) + half).clamp(0, top)
    n_p0 = (sc(ps0 + f2) + half).clamp(0, top)
    f3 = torch.where(hev, 0, (f1 + 1) >> 1)
    n_q1 = (sc(qs1 - f3) + half).clamp(0, top)
    n_p1 = (sc(ps1 + f3) + half).clamp(0, top)
    outp[0] = torch.where(w4, n_p0, outp[0])
    outp[1] = torch.where(w4, n_p1, outp[1])
    outq[0] = torch.where(w4, n_q0, outq[0])
    outq[1] = torch.where(w4, n_q1, outq[1])

    near = w14 | w8 | w6 | w4
    wrote_p = [near, near, w14 | w8, w14, w14, w14]
    wrote_q = [near, near, w14 | w8, w14, w14, w14]
    return outp, outq, wrote_p, wrote_q


def _pass_axis1(plane, flen_c, lvl_c, sharpness, bd):
    """Filter all axis-1 ("vertical", between-columns) edges of one
    plane [H, W] int32.  flen_c/lvl_c: [n4, K4] int32 cell maps from
    build_deblock_maps (edge at column 4k, cell row a covers pixel
    rows 4a..4a+3); cells beyond the cropped frame carry flen 0."""
    H, W = plane.shape
    K = -(-W // 4)
    W4 = K * 4
    n4, k4 = flen_c.shape

    def cat_zeros(a, left, right):
        z = torch.zeros((a.shape[0], 1), dtype=a.dtype, device=a.device)
        return torch.cat([z.expand(-1, left), a, z.expand(-1, right)], dim=1)

    # cell maps -> per-pixel-row [H, K] (rows beyond the map: no filter)
    def ex(m):
        m = cat_zeros(m, 0, K - k4) if k4 < K else m[:, :K]
        r = m[:, None, :].expand(n4, 4, K).reshape(n4 * 4, K)
        if n4 * 4 >= H:
            return r[:H]
        return torch.cat([r, torch.zeros((H - n4 * 4, K), dtype=r.dtype,
                                          device=r.device)], dim=0)

    flen = ex(flen_c)
    limit, blimit, thresh = _thresholds(ex(lvl_c), sharpness)

    # the 14 edge-crossing taps as strided slices; zero padding
    # mirrors the host's zero-filled out-of-bounds P/Q lanes
    Z = cat_zeros(plane.to(torch.int32), 8, 8 + W4 - W)
    S = [Z[:, 8 + d::4][:, :K] for d in range(-7, 7)]
    p = [S[6 - i] for i in range(7)]
    q = [S[7 + i] for i in range(7)]

    outp, outq, wrote_p, wrote_q = _filter_edges(
        p, q, flen, limit, blimit, thresh, bd)

    def shl(a, n):   # writer edge is n lattice steps to the right
        return cat_zeros(a, 0, n)[:, n:]

    def shr(a, n):   # writer edge is n lattice steps to the left
        return cat_zeros(a, n, 0)[:, :K]

    # recombine: position 4k+j can be written by edge k (as q_j), edge
    # k+1 (as p_{3-j}), edge k-1 (as q_{j+4}, j<2) or edge k+2 (as
    # p_{7-j}, j>=2); at most one mask is true (pass independence)
    cols = []
    for j in range(4):
        out_j = torch.where(wrote_q[j], outq[j], q[j])
        out_j = torch.where(shl(wrote_p[3 - j], 1),
                            shl(outp[3 - j], 1), out_j)
        if j < 2:
            out_j = torch.where(shr(wrote_q[4 + j], 1),
                                shr(outq[4 + j], 1), out_j)
        else:
            out_j = torch.where(shl(wrote_p[7 - j], 2),
                                shl(outp[7 - j], 2), out_j)
        cols.append(out_j)
    out = torch.stack(cols, dim=2).reshape(H, W4)
    return out[:, :W]


def deblock_planes(planes, maps, sharpness, bd):
    """Both deblock passes for all planes.  `planes`: [H, W] int32
    tensors of pixels in [0, 2^bd) (the kernel keeps them as int16);
    `maps`: per plane ((flen_v, lvl_v), (flen_h, lvl_h)) int32 tensors on
    the planes' device; `sharpness`: int.  Planes on a card run the
    kernel, planes on the CPU the plain version."""
    dev = planes[0].device
    if dev.type == "cpu":
        return _deblock_plain(planes, maps, sharpness, bd)
    if dev.type == "cuda":
        return _deblock_kernel(planes, maps, sharpness, bd)
    raise ValueError(f"deblock_planes: unsupported device {dev}")


def _deblock_plain(planes, maps, sharpness, bd):
    """The plain version: `_pass_axis1` over each plane and its
    transpose, on any device (`deblock_planes`' arguments)."""
    outs = []
    for plane, ((fv, lv), (fh, lh)) in zip(planes, maps):
        x = _pass_axis1(plane.to(torch.int32), fv, lv, sharpness, bd)
        x = _pass_axis1(x.T, fh, lh, sharpness, bd).T
        outs.append(x)
    return tuple(outs)


def _deblock_kernel(planes, maps, sharpness, bd):
    """Both passes on the card: one `deblock_frame` launch for every plane,
    on the planes' device and its current stream, counted in `launches`.
    The planes are read in place through their row stride; returns new
    contiguous int32 planes.  Raises on inputs the kernel does not take
    or a failed launch."""
    global launches
    dev = planes[0].device
    if not 1 <= len(planes) <= MAX_PLANES or len(maps) != len(planes) or \
            bd not in (8, 10, 12) or int(sharpness) not in range(8):
        raise ValueError(f"deblock_planes: {len(planes)} planes, {len(maps)} "
                         f"maps, {bd} bits, sharpness {sharpness}: the "
                         f"kernel takes 1 to {MAX_PLANES} planes, 8, 10 or "
                         f"12 bits, sharpness 0 to 7")
    for p in planes:
        if p.device != dev or p.dtype != torch.int32 or p.ndim != 2 or \
                p.stride(1) != 1 or p.numel() == 0:
            raise ValueError(f"deblock_planes: planes must be non-empty "
                             f"int32 [H, W] rows on {dev}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    for m in (m for pair in maps for d in pair for m in d):
        if m.device != dev or m.dtype != torch.int32 or m.ndim != 2 or \
                not m.is_contiguous():
            raise ValueError(f"deblock_planes: maps must be contiguous "
                             f"int32 [n4, k4] on {dev}")
    sizes = [p.numel() for p in planes]
    out = [o.view(p.shape) for o, p in zip(
        torch.empty(sum(sizes), dtype=torch.int32, device=dev).split(sizes),
        planes)]
    launch("deblock", "deblock_frame", dev,
           _params(sharpness, bd, planes, out, maps), len(planes))
    launches += 1
    return tuple(out)


def _params(sharpness, bd, src, dst, maps):
    """The kernel's parameters in `_PARAMS` order: tensors where it takes
    a pointer, ints; a plane the frame does not have is 0 throughout."""
    params = dict(sharp=int(sharpness), bd=bd, nplanes=len(src))
    for i, (s, d, pair) in enumerate(zip(src, dst, maps)):
        params.update({f"src{i}": s, f"src_stride{i}": s.stride(0),
                       f"dst{i}": d, f"dst_stride{i}": d.stride(0),
                       f"h{i}": s.shape[0], f"w{i}": s.shape[1]})
        for axis, (flen, lvl) in zip("vh", pair):
            params.update({f"flen_{axis}{i}": flen, f"lvl_{axis}{i}": lvl,
                           f"n4_{axis}{i}": flen.shape[0],
                           f"k4_{axis}{i}": flen.shape[1]})
    return param_list(_PARAMS, params)
