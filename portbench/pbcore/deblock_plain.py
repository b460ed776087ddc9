"""Which filter each deblock edge line runs, for the bound of a deblock
launch (`work.deblock_work`) [SPEC §7.14].

A frozen copy of the port's plain deblock (`ops/kernels/deblock.py`:
`_thresholds`, `_filter_edges`, `_pass_axis1`, `_deblock_plain`), so
that a change to the program cannot move the yardstick: both passes of
every plane run here, the second on the first's output, and each pass
counts its edge lines by length and by the filter that runs.
`tests/test_portbench_work.py` holds its output to the program's plain
version."""
import torch

# edge line kinds counted: decisions by length, then the filter run
KINDS = ("len4", "len6", "len8", "len14", "wide", "8", "6", "4")


def thresholds(lvl, sharpness):
    """(limit, blimit, thresh) from the edge filter level map
    [SPEC §7.14.4]."""
    shift = (1 if sharpness > 0 else 0) + (1 if sharpness > 4 else 0)
    limit = lvl >> shift
    if sharpness > 0:
        limit = limit.clamp(max=9 - sharpness)
    limit = limit.clamp(min=1)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    return limit, blimit, thresh


def filter_edges(p, q, length, limit, blimit, thresh, bd, counts):
    """The edge filters over the lattice [SPEC §7.14.6]; p, q: lists of
    7 [H, K] int32 tensors (p[0] = p0 next to the edge).  Returns
    (outp, outq, wrote_p, wrote_q) and adds the lines of each kind to
    `counts`."""
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

    outp, outq = list(p), list(q)
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
    mid = w14 | w8
    # a length-6 line whose 5-tap ran: near, not mid, flat6
    w6_run = near & ~mid & (length == 6) & flat6
    seen = {"len4": int((length == 4).sum()),
            "len6": int((length == 6).sum()),
            "len8": int(((length >= 8) & (length != 14)).sum()),
            "len14": int((length == 14).sum()),
            "wide": int(w14.sum()), "8": int((mid & ~w14).sum()),
            "6": int(w6_run.sum()), "4": int((near & ~mid & ~w6_run).sum())}
    for k, v in seen.items():
        counts[k] = counts.get(k, 0) + v
    wrote = [near, near, mid, w14, w14, w14]
    return outp, outq, wrote, list(wrote)


def pass_axis1(plane, flen_c, lvl_c, sharpness, bd, counts):
    """All axis-1 (between-columns) edges of one plane [H, W] int32;
    flen_c/lvl_c: [n4, K4] int32 cell maps (edge at column 4k, cell row
    a covers pixel rows 4a..4a+3; cells beyond the frame carry 0)."""
    H, W = plane.shape
    K = -(-W // 4)
    W4 = K * 4
    n4, k4 = flen_c.shape

    def cat_zeros(a, left, right):
        z = torch.zeros((a.shape[0], 1), dtype=a.dtype, device=a.device)
        return torch.cat([z.expand(-1, left), a, z.expand(-1, right)], dim=1)

    def ex(m):
        m = cat_zeros(m, 0, K - k4) if k4 < K else m[:, :K]
        r = m[:, None, :].expand(n4, 4, K).reshape(n4 * 4, K)
        if n4 * 4 >= H:
            return r[:H]
        return torch.cat([r, torch.zeros((H - n4 * 4, K), dtype=r.dtype,
                                          device=r.device)], dim=0)

    flen = ex(flen_c)
    limit, blimit, thresh = thresholds(ex(lvl_c), sharpness)
    Z = cat_zeros(plane.to(torch.int32), 8, 8 + W4 - W)
    S = [Z[:, 8 + d::4][:, :K] for d in range(-7, 7)]
    p = [S[6 - i] for i in range(7)]
    q = [S[7 + i] for i in range(7)]
    outp, outq, wrote_p, wrote_q = filter_edges(
        p, q, flen, limit, blimit, thresh, bd, counts)

    def shl(a, n):
        return cat_zeros(a, 0, n)[:, n:]

    def shr(a, n):
        return cat_zeros(a, n, 0)[:, :K]

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
    return torch.stack(cols, dim=2).reshape(H, W4)[:, :W]


def deblock(planes, maps, sharpness, bd):
    """Both passes of every plane, as the port's `deblock_planes` takes
    them; (the filtered planes, the edge lines of each kind)."""
    counts = dict.fromkeys(KINDS, 0)
    outs = []
    for plane, ((fv, lv), (fh, lh)) in zip(planes, maps):
        x = pass_axis1(plane.to(torch.int32), fv, lv, sharpness, bd, counts)
        x = pass_axis1(x.T, fh, lh, sharpness, bd, counts).T
        outs.append(x)
    return tuple(outs), counts
