"""Wavefront intra reconstruction on the device.

Port of `av1dec_tpu.ops.kernels.wavefront` [SPEC §7.11.2, SURVEY §7.1].
The host builds a level schedule with all control flow precomputed as
per-block int scalars (`pipeline/wavefront.py`); the device executes
gathers, integer arithmetic and scatters.

`scan_into` is the whole-batch scan.  A CUDA frame buffer runs the
hand-written kernel `csrc/wavefront_scan.cu`, one persistent launch for
the whole batch (counted in `launches`): its blocks take the lanes in
the level-major ticket order `plan_levels` builds and wait on device
counters, not on launch boundaries, for the level before; a CPU buffer
runs the plain version `_scan_plain`; nothing else is accepted.  The
schedule puts every block's prediction inputs at strictly earlier
levels, so the lanes of one level are independent and the windows of
the plain version are not needed on the card.

`_scan_plain` keeps the JAX package's lanes and windows: blocks are
grouped into shape buckets T in {16, 32, 64}, each level is split into
windows of at most Bmax lanes, lockstep across buckets (`make_windows`,
unchanged).  What differs, because torch runs eagerly:

* The scan is a host loop over windows.  Every decision the JAX scan
  takes at run time with `lax.cond` (empty window, and the expensive
  families: directional, palette, filter-intra, CfL) is read from host
  arrays built once per batch by `plan_windows`, so the loop never waits
  for the device (on a card it runs under torch's sync debug mode
  "error", so a synchronisation inside it raises).  A window runs on
  exactly its `count` lanes instead of Bmax masked ones; the lanes'
  results are the same.
* MF_INTER lanes (inter blocks with a residual; the MC pass already
  wrote their prediction into the frame buffer) run in the windows that
  hold one (host flag FLAG_INTER).  Such lanes exist only in schedules
  built with `allow_inter`, so the JAX config's optional 6th element
  `has_inter`, which keeps its jit keys stable, is accepted and ignored.
* JAX's gathers clamp out-of-range indices; every index here is clamped
  to the same range (the frame's last pixel) or is in range by
  construction.  JAX's scatter `mode="drop"` becomes a write to a trash
  slot one past the end of the frame buffer.
* Filter-intra's serial patch recursion runs only as many patches as the
  window's largest filter-intra block has.

All pixel math is int32, bit-exact with the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1dec_tpu_torch import tracing
from av1dec_tpu_torch.ops.kernels.cuda_build import (launch, no_device_sync,
                                                     param_list)
from av1dec_tpu_torch.ops.spec import intra
from av1dec_tpu_torch.ops.tables_data import FILTER_INTRA_TAPS, SM_WEIGHTS
from av1dec_tpu_torch.pipeline.wavefront import (MF_DC, MF_DIR, MF_FI, MF_H,
                                                 MF_INTER, MF_PAETH, MF_PAL,
                                                 MF_SMOOTH, MF_SMOOTH_V,
                                                 MF_V, _SCALAR_FIELDS)

# device packing appends the per-lane block geometry to the shared
# scalar schedule fields
_DEV_FIELDS = list(_SCALAR_FIELDS) + ["w", "h", "lw", "lh", "lbase"]
_F = {name: i for i, name in enumerate(_DEV_FIELDS)}
_KERN = np.concatenate([np.zeros((1, 5), np.int64),
                        np.asarray(intra.INTRA_EDGE_KERNELS)],
                       axis=0).astype(np.int32)
_SM = np.asarray(SM_WEIGHTS, np.int32)
_FI_TAPS = np.asarray(FILTER_INTRA_TAPS, np.int32)[:, :, :7]  # [5, 8, 7]

# per-window host flags (plan_windows): columns of the [S, nb, 5] array
FLAG_DIR, FLAG_PAL, FLAG_CFL, FLAG_FI_PATCHES, FLAG_INTER = range(5)

# launches of the CUDA scan kernel in this process (one per scan with
# lanes)
launches = 0
# the last launch's (counter buffer, lanes of each level with lanes), for
# `levels_completed`
last_scan = None
# the kernel's int64 parameter array (`csrc/wavefront_scan.cu`, enum
# Param): pointers, then ints; up to 3 buckets
_PARAMS = ["frame", "res", "rows0", "rows1", "rows2", "pal0", "pal1",
           "pal2", "tickets", "counters", "kern", "sm", "fi_taps", "n",
           "res_len", "res_bytes", "sm_len", "nb", "t0", "t1", "t2", "bd",
           "sub_x", "sub_y", "eef"]
# columns of the ticket table (`plan_levels`; enum Ticket of the source)
_TICKET = ["bucket", "row", "level", "wait"]
# ints from one level's done counter to the next in the counter buffer
# (kCounterStride): [0] is the ticket counter, [(k + 1) * stride] the
# lanes of the k-th level with lanes that the kernel published
COUNTER_STRIDE = 32


def make_windows(starts_by_t, counts_by_t, bcaps, ts):
    """Split per-level lane runs into <= Bcap-lane windows, lockstep
    across buckets: level l contributes max_b(ceil(c_bl / Bcap_b)) steps
    and every bucket pads that level to the same step count, so no
    window of a later level ever precedes one of an earlier level.
    Returns (win_starts [S, nb], win_counts [S, nb]) int32."""
    import numpy as np
    L = len(counts_by_t[ts[0]])
    sub = np.zeros(L, np.int64)
    for t in ts:
        sub = np.maximum(sub, -(-counts_by_t[t].astype(np.int64)
                                // bcaps[t]))
    S = int(sub.sum())
    ws = np.zeros((S, len(ts)), np.int32)
    wc = np.zeros((S, len(ts)), np.int32)
    pos = np.concatenate([[0], np.cumsum(sub)[:-1]]).astype(np.int64)
    for bi, t in enumerate(ts):
        B = bcaps[t]
        st, cn = starts_by_t[t], counts_by_t[t]
        for lvl in range(L):
            c = int(cn[lvl])
            p = int(pos[lvl])
            k = 0
            while c > 0:
                ws[p + k, bi] = st[lvl] + k * B
                wc[p + k, bi] = min(B, c)
                c -= B
                k += 1
    return ws, wc


def window_flags(packed_by_t, ws, wc, ts):
    """Host flags of every (window, bucket) from the packed lane rows:
    [S, nb, 5] int64 with FLAG_DIR / FLAG_PAL / FLAG_CFL / FLAG_INTER
    (the window has such a lane) and FLAG_FI_PATCHES (4x2 patches of the
    window's largest filter-intra block; 0 = no filter-intra lane)."""
    S = ws.shape[0]
    flags = np.zeros((S, len(ts), 5), np.int64)
    for bi, t in enumerate(ts):
        rows = packed_by_t[t]
        mf = rows[:, _F["mode_family"]]
        lo = ws[:, bi].astype(np.int64)
        hi = lo + wc[:, bi]
        for col, lane in ((FLAG_DIR, mf == MF_DIR), (FLAG_PAL, mf == MF_PAL),
                          (FLAG_CFL, rows[:, _F["cfl_maxx"]] > 0),
                          (FLAG_INTER, mf == MF_INTER)):
            cs = np.concatenate([[0], np.cumsum(lane)])
            flags[:, bi, col] = cs[hi] - cs[lo] > 0
        patches = np.where(mf == MF_FI, (rows[:, _F["h"]] >> 1) *
                           (rows[:, _F["w"]] >> 2), 0)
        cs = np.concatenate([[0], np.cumsum(patches > 0)])
        for s in np.nonzero(cs[hi] - cs[lo] > 0)[0]:
            flags[s, bi, FLAG_FI_PATCHES] = patches[lo[s]:hi[s]].max()
    return flags


def plan_windows(packed_by_t, starts_by_t, counts_by_t, buckets):
    """Windows of a batch and their host flags: (ws, wc, flags), all
    numpy, built once before the scan (`prep_batch`)."""
    ts = [t for t, _ in buckets]
    bcaps = {t: b for t, b in buckets}
    ws, wc = make_windows(starts_by_t, counts_by_t, bcaps, ts)
    return ws, wc, window_flags(packed_by_t, ws, wc, ts)


def plan_levels(starts_by_t, counts_by_t, ts):
    """The kernel's view of a batch, all numpy: (table [L, nb, 2] int32,
    (start, count) of each level's run of lanes in each bucket's rows;
    lanes [L] int64, the lanes of each level over all buckets; tickets
    [N, 4] int32, every lane once in level-major order (levels with
    lanes only, buckets in order inside a level, rows in order inside a
    bucket), with the columns of `_TICKET`: its bucket, its row, its
    level's index among the levels with lanes, and the lanes of the
    previous level with lanes, which that level's done counter must
    reach before it runs (0 at the first))."""
    table = np.stack([np.stack([np.asarray(starts_by_t[t], np.int32),
                                np.asarray(counts_by_t[t], np.int32)],
                               axis=1) for t in ts], axis=1)
    lanes = table[:, :, 1].astype(np.int64).sum(axis=1)
    live = np.nonzero(lanes)[0]
    runs = table[live].reshape(-1, 2).astype(np.int64)  # level-major
    counts = runs[:, 1]
    first = np.cumsum(counts) - counts
    total = int(counts.sum())
    rank = np.repeat(np.arange(len(live)), len(ts))
    waits = np.concatenate([[0], lanes[live][:-1]])
    tickets = np.stack([
        np.repeat(np.tile(np.arange(len(ts)), len(live)), counts),
        np.repeat(runs[:, 0] - first, counts) + np.arange(total),
        np.repeat(rank, counts), np.repeat(waits[rank], counts)],
        axis=1).astype(np.int32)
    return table, lanes, tickets


@functools.lru_cache(maxsize=None)
def _consts(device):
    """The scan's constant tables on `device`, uploaded once, contiguous
    (the kernel reads them by pointer)."""
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "ar": torch.arange(4 * 64 + 3, **i32),
        "kern": tracing.to_device(_KERN, **i32).contiguous(),
        "sm": tracing.to_device(_SM, **i32).contiguous(),
        "fi_taps": tracing.to_device(_FI_TAPS, **i32).contiguous(),
    }


def _gather_edges(frame, n, sv, T, bd, ar):
    """AboveRow/LeftCol for B lanes; static edge extent 2T (per-lane
    limits clamp the reads, extra lanes/pixels are masked later).
    `n`: pixels of the frame buffer (its trash slot excluded)."""
    size = 2 * T
    x, y = sv["x"], sv["y"]
    base, stride = sv["base"], sv["stride"]
    i = ar[:size]

    def at(idx):
        return frame[idx.clamp(0, n - 1).long()]

    cols = torch.minimum(x[:, None] + i[None, :], sv["above_lim"][:, None])
    idx_a = base[:, None] + (y[:, None] - 1) * stride[:, None] + cols
    idx_rep_a = base + y * stride + (x - 1)
    idx_a = torch.where((sv["above_case"] == 1)[:, None],
                        idx_rep_a[:, None], idx_a)
    above_v = torch.where((sv["above_case"] == 2)[:, None],
                          (1 << (bd - 1)) - 1, at(idx_a))
    rows = torch.minimum(y[:, None] + i[None, :], sv["left_lim"][:, None])
    idx_l = base[:, None] + rows * stride[:, None] + (x - 1)[:, None]
    idx_rep_l = base + (y - 1) * stride + x
    idx_l = torch.where((sv["left_case"] == 1)[:, None],
                        idx_rep_l[:, None], idx_l)
    left_v = torch.where((sv["left_case"] == 2)[:, None],
                         (1 << (bd - 1)) + 1, at(idx_l))
    cc = sv["corner_case"]
    idx_c = torch.where(cc == 0, base + (y - 1) * stride + (x - 1),
                        torch.where(cc == 1, base + (y - 1) * stride + x,
                                    base + y * stride + (x - 1)))
    corner = torch.where(cc == 3, 1 << (bd - 1), at(idx_c))
    above = torch.cat([corner[:, None], above_v], dim=1)
    left = torch.cat([corner[:, None], left_v], dim=1)
    return above, left


def _take(edge, idx):
    """edge[b, idx[b, ...]] for a [B, n] edge (indices in range)."""
    B = edge.shape[0]
    return edge.gather(1, idx.reshape(B, -1).long()).reshape(idx.shape)


def _edge_filter(edge, npx, strength, c):
    B, n = edge.shape
    i = c["ar"][:n]
    acc = torch.zeros_like(edge)
    kv = c["kern"][strength.clamp(0, 3).long()]
    hi = (npx.clamp(min=1) - 1).clamp(max=n - 1)[:, None]
    for j in range(5):
        k = torch.minimum((i[None, :] - 2 + j).clamp(min=0), hi)
        acc = acc + kv[:, j][:, None] * _take(edge, k)
    sm = (acc + 8) >> 4
    upd = (strength > 0)[:, None] & (i[None, :] >= 1) & \
        (i[None, :] < npx[:, None])
    return torch.where(upd, sm, edge)


def _upsample(edge, npx, bd, c):
    B, n = edge.shape
    size = n - 1
    i = c["ar"][:size + 3]
    src = torch.minimum((i[None, :] - 1).clamp(min=0), npx[:, None])
    inb = _take(edge, src)
    s = (-inb[:, :size] + 9 * inb[:, 1:size + 1] +
         9 * inb[:, 2:size + 2] - inb[:, 3:size + 3])
    s = ((s + 8) >> 4).clamp(0, (1 << bd) - 1)
    # out[0] = inb[0], out[2i+1] = s[i], out[2i+2] = inb[i+2], out[-1] = 0
    mid = torch.stack([s, inb[:, 2:size + 2]], dim=2).reshape(B, 2 * size)
    return torch.cat([inb[:, :1], mid, torch.zeros_like(inb[:, :1])], dim=1)


def _dir_lut(edge, edge_up, up, npx_u, c):
    B, n = edge.shape
    size = n - 1
    lutlen = 2 * size + 3
    k = c["ar"][:lutlen]
    lut_n = edge[:, (k - 1).clamp(0, size).long()]
    lut_u = edge_up[:, k.clamp(max=2 * size + 1).long()]
    tail = _take(edge, (npx_u + 1).clamp(max=size)[:, None])
    lut_u = torch.where(k[None, :] < (2 * npx_u + 2)[:, None], lut_u, tail)
    return torch.where((up > 0)[:, None], lut_u, lut_n)


def _predict_dir(above, left, sv, T, bd, enable_edge_filter, c):
    """Directional prediction; per-lane block dims (w, h) as data.
    Pixels beyond (h_l, w_l) compute garbage and are masked at the
    scatter. [SPEC §7.11.2.4]"""
    B = above.shape[0]
    ar = c["ar"]
    w_l = sv["w"][:, None, None]
    h_l = sv["h"][:, None, None]
    size_l = w_l + h_l                      # per-lane w + h
    lutmax = 4 * T + 2                      # static lut upper index
    p_angle = sv["p_angle"]
    if enable_edge_filter:
        do_c = sv["corner_filt"] > 0
        cv = (left[:, 1] * 5 + above[:, 0] * 6 + above[:, 1] * 5 + 8) >> 4
        above = torch.cat([torch.where(do_c, cv, above[:, 0])[:, None],
                           above[:, 1:]], dim=1)
        left = torch.cat([torch.where(do_c, cv, left[:, 0])[:, None],
                          left[:, 1:]], dim=1)
        above = _edge_filter(above, sv["npx_above"], sv["str_above"], c)
        left = _edge_filter(left, sv["npx_left"], sv["str_left"], c)
    up_a, up_l = sv["up_above"], sv["up_left"]
    npx_a = sv["w"] + torch.where(p_angle < 90, sv["h"], 0)
    npx_l = sv["h"] + torch.where(p_angle > 180, sv["w"], 0)
    lutA = _dir_lut(above, _upsample(above, npx_a, bd, c), up_a, npx_a, c)
    lutL = _dir_lut(left, _upsample(left, npx_l, bd, c), up_l, npx_l, c)

    jj = ar[:T][None, None, :]
    ii = ar[:T][None, :, None]
    dx = sv["dx"][:, None, None]
    dy = sv["dy"][:, None, None]
    ua = up_a[:, None, None]
    ul = up_l[:, None, None]
    pa = p_angle[:, None, None]

    def lerp(lut, b, shift):
        return _take(lut, b + 2) * (32 - shift) + \
            _take(lut, (b + 3).clamp(max=lutmax)) * shift

    idx1 = (ii + 1) * dx
    base1 = (idx1 >> (6 - ua)) + (jj << ua)
    max_base_x = (size_l - 1) << ua
    shift1 = ((idx1 << ua) >> 1) & 0x1F
    v1 = lerp(lutA, torch.minimum(base1, max_base_x), shift1)
    mbx2 = (max_base_x[:, 0, 0] + 2).clamp(max=lutmax)
    z1 = torch.where(base1 < max_base_x, (v1 + 16) >> 5,
                     _take(lutA, mbx2[:, None]).reshape(B, 1, 1))

    idx2 = (jj << 6) - (ii + 1) * dx
    base2 = idx2 >> (6 - ua)
    shift2 = ((idx2 << ua) >> 1) & 0x1F
    va = lerp(lutA, torch.minimum(base2.clamp(min=-2), size_l * 2), shift2)
    idx2l = (ii << 6) - (jj + 1) * dy
    base2l = idx2l >> (6 - ul)
    shift2l = ((idx2l << ul) >> 1) & 0x1F
    vl = lerp(lutL, torch.minimum(base2l.clamp(min=-2), size_l * 2),
              shift2l)
    z2 = torch.where(base2 >= -(1 << ua), (va + 16) >> 5, (vl + 16) >> 5)

    idx3 = (jj + 1) * dy
    base3 = (idx3 >> (6 - ul)) + (ii << ul)
    max_base_y = (size_l - 1) << ul
    shift3 = ((idx3 << ul) >> 1) & 0x1F
    v3 = lerp(lutL, torch.minimum(base3, max_base_y), shift3)
    mby2 = (max_base_y[:, 0, 0] + 2).clamp(max=lutmax)
    z3 = torch.where(base3 < max_base_y, (v3 + 16) >> 5,
                     _take(lutL, mby2[:, None]).reshape(B, 1, 1))

    return torch.where(pa < 90, z1, torch.where(pa < 180, z2, z3))


def _predict_fi(above, left, sv, T, bd, n_patches, c):
    """Filter-intra: serial 4x2 patch recursion [SPEC §7.11.2.3], for
    `n_patches` patches in recursion order (the largest filter-intra
    block of the window; smaller blocks' surplus patches write only the
    trash slot).  Per-lane patch-grid dims; filter-intra blocks are
    <= 32x32."""
    B = above.shape[0]
    ar = c["ar"]
    w_l, h_l = sv["w"], sv["h"]
    lw = sv["lw"]
    tv = c["fi_taps"][sv["fi_mode"].clamp(0, 4).long()]      # [B, 8, 7]
    n_j = w_l >> 2
    n_patch = (h_l >> 1) * n_j
    W1 = w_l + 1
    buflen = (T + 1) * (T + 1)
    hi = (1 << bd) - 1

    # init: top row 0..w_l, left column rows 1..h_l (per-lane stride W1);
    # index buflen is the trash slot
    buf = torch.zeros((B, buflen + 1), dtype=torch.int32,
                      device=above.device)
    col = ar[:T + 1][None, :]
    dst0 = torch.where(col <= w_l[:, None], col, buflen)
    buf.scatter_(1, dst0.long(), above[:, :T + 1])
    irow = ar[:T][None, :]
    dstl = torch.where(irow < h_l[:, None], (irow + 1) * W1[:, None], buflen)
    buf.scatter_(1, dstl.long(), left[:, 1:T + 1])

    ok = ar[:8][None, :]
    k5 = ar[:5][None, :]
    shift = (lw - 2).clamp(min=0)
    for p in range(n_patches):
        pt = ar[p]
        sj = pt & (n_j - 1)
        si = pt >> shift
        i = 1 + 2 * si
        j = 1 + 4 * sj
        o = (i - 1) * W1 + (j - 1)
        g = torch.cat([o[:, None] + k5, (o + W1)[:, None],
                       (o + 2 * W1)[:, None]], dim=1)          # [B, 7]
        pv = buf.gather(1, g.clamp(0, buflen).long())         # [B, 7]
        s = (tv * pv[:, None, :]).sum(-1, dtype=torch.int32)  # [B, 8]
        v = torch.where(s >= 0, (s + 8) >> 4, -((-s + 8) >> 4))
        v = v.clamp(0, hi)
        dst = (i * W1 + j)[:, None] + (ok & 3) + (ok >> 2) * W1[:, None]
        dst = torch.where(pt < n_patch[:, None], dst, buflen)
        buf.scatter_(1, dst.long(), v)
    ii = ar[:T][None, :, None]
    jj = ar[:T][None, None, :]
    gidx = (ii + 1) * W1[:, None, None] + (jj + 1)
    return _take(buf, gidx.expand(B, T, T))


def _smooth_all(above, left, sv, T, c):
    """All three smooth modes, per-lane dims. [SPEC §7.11.2.6]"""
    sm = c["sm"]
    w_l, h_l = sv["w"], sv["h"]
    jj = c["ar"][:T]
    top = _SM.shape[0] - 1
    sw_w = sm[(w_l[:, None] + jj[None, :]).clamp(0, top).long()]
    sw_h = sm[(h_l[:, None] + jj[None, :]).clamp(0, top).long()]
    sw_w = sw_w[:, None, :]                                   # [B, 1, T]
    sw_h = sw_h[:, :, None]                                   # [B, T, 1]
    a = above[:, None, 1:1 + T]
    l = left[:, 1:1 + T, None]
    right = _take(above, w_l[:, None])[:, :, None]
    bottom = _take(left, h_l[:, None])[:, :, None]
    full = (sw_h * a + (256 - sw_h) * bottom +
            sw_w * l + (256 - sw_w) * right + 256) >> 9
    vert = (sw_h * a + (256 - sw_h) * bottom + 128) >> 8
    horz = (sw_w * l + (256 - sw_w) * right + 128) >> 8
    mf = sv["mode_family"][:, None, None]
    return torch.where(mf == MF_SMOOTH, full,
                       torch.where(mf == MF_SMOOTH_V, vert, horz))


def _paeth_b(above, left, T):
    a = above[:, None, 1:1 + T]
    l = left[:, 1:1 + T, None]
    tl = above[:, 0][:, None, None]
    base = a + l - tl
    pa = (base - a).abs()
    pl = (base - l).abs()
    ptl = (base - tl).abs()
    return torch.where((pa <= pl) & (pa <= ptl), a,
                       torch.where(pl <= ptl, l, tl))


def _cfl_adjust(frame, n, pred, sv, T, bd, sub_x, sub_y, pixmask, c):
    """CfL: subsample co-located luma, remove average, scale, add.
    [SPEC §7.11.5]"""
    B = pred.shape[0]
    ar = c["ar"]
    lstride = (sv["stride"] << sub_x)[:, None, None]
    lbase = sv["lbase"][:, None, None]  # luma plane base (batch offset)
    ii = ar[:T][None, :, None]
    jj = ar[:T][None, None, :]
    ly = torch.minimum((sv["y"][:, None, None] + ii) << sub_y,
                       sv["cfl_maxy"][:, None, None])
    lx = torch.minimum((sv["x"][:, None, None] + jj) << sub_x,
                       sv["cfl_maxx"][:, None, None])
    b = (lbase + ly * lstride + lx).clamp(min=0)

    def at(idx):
        return frame[idx.clamp(max=n - 1).long()]

    if sub_x and sub_y:
        t = (at(b) + at(b + 1) + at(b + lstride) + at(b + lstride + 1)) << 1
    elif sub_x:
        t = (at(b) + at(b + 1)) << 2
    else:
        t = at(b) << 3
    shift = sv["lw"] + sv["lh"]
    tot = torch.where(pixmask, t, 0).reshape(B, -1).sum(1, dtype=torch.int32)
    avg = (tot + (1 << (shift - 1).clamp(min=0))) >> shift
    ac = t - avg[:, None, None]
    sc = sv["cfl_alpha"][:, None, None] * ac
    scaled = torch.where(sc >= 0, (sc + 32) >> 6, -((-sc + 32) >> 6))
    return (pred + scaled).clamp(0, (1 << bd) - 1)


def _apply_bucket(frame, n, rows, res_flat, pal_t, flags, *, T, bd, sub_x,
                  sub_y, eef, c):
    """One window of one bucket: predict its lanes (`rows`, [B, F] int32,
    every lane valid), add the residual, scatter into `frame` in place.
    `flags`: this window's host flags (window_flags)."""
    B = rows.shape[0]
    ar = c["ar"]
    sv = {f: rows[:, k] for f, k in _F.items()}
    w_l, h_l = sv["w"], sv["h"]
    above, left = _gather_edges(frame, n, sv, T, bd, ar)
    mf = sv["mode_family"]
    ii = ar[:T][None, :, None]
    jj = ar[:T][None, None, :]
    pixmask = (ii < h_l[:, None, None]) & (jj < w_l[:, None, None])
    fidx_raw = (sv["base"][:, None, None] +
                (sv["y"][:, None, None] + ii) * sv["stride"][:, None, None] +
                sv["x"][:, None, None] + jj)

    # cheap families computed unconditionally, selected by mask
    out = _smooth_all(above, left, sv, T, c)
    out = torch.where((mf == MF_V)[:, None, None], above[:, None, 1:1 + T],
                      out)
    out = torch.where((mf == MF_H)[:, None, None], left[:, 1:1 + T, None],
                      out)
    out = torch.where((mf == MF_PAETH)[:, None, None],
                      _paeth_b(above, left, T), out)
    # DC with per-lane masked sums
    jr = ar[:T][None, :]
    s_a = torch.where(jr < w_l[:, None], above[:, 1:1 + T], 0) \
        .sum(1, dtype=torch.int32)
    s_l = torch.where(jr < h_l[:, None], left[:, 1:1 + T], 0) \
        .sum(1, dtype=torch.int32)
    size_l = w_l + h_l
    dc_case = sv["dc_case"]
    avg = torch.where(
        dc_case == 0, (s_a + s_l + (size_l >> 1)) // size_l,
        torch.where(dc_case == 1, (s_a + (w_l >> 1)) >> sv["lw"],
                    torch.where(dc_case == 2,
                                (s_l + (h_l >> 1)) >> sv["lh"],
                                1 << (bd - 1))))
    dc = avg[:, None, None].expand(B, T, T)
    if flags[FLAG_CFL]:
        has_cfl = sv["cfl_maxx"] > 0
        dc = torch.where(has_cfl[:, None, None],
                         _cfl_adjust(frame, n, dc, sv, T, bd, sub_x, sub_y,
                                     pixmask, c), dc)
    out = torch.where((mf == MF_DC)[:, None, None], dc, out)

    # expensive / rare families, only in windows that hold them
    if flags[FLAG_DIR]:
        out = torch.where((mf == MF_DIR)[:, None, None],
                          _predict_dir(above, left, sv, T, bd, eef, c), out)
    if flags[FLAG_PAL]:
        out = torch.where((mf == MF_PAL)[:, None, None],
                          pal_t[sv["pal_idx"].clamp(min=0).long()], out)
    if flags[FLAG_FI_PATCHES]:
        out = torch.where((mf == MF_FI)[:, None, None],
                          _predict_fi(above, left, sv, T, bd,
                                      int(flags[FLAG_FI_PATCHES]), c), out)
    if flags[FLAG_INTER]:
        # inter residual lane: the MC pass already wrote this block's
        # prediction into the frame; gather it back, the shared residual
        # add below then clips and rewrites it
        out = torch.where((mf == MF_INTER)[:, None, None],
                          frame[fidx_raw.clamp(0, n - 1).long()], out)

    # residual: per-lane pixel window of the packed flat buffer
    roff = sv["res_idx"]
    rpix = roff[:, None, None] + ii * w_l[:, None, None] + jj
    res = res_flat[rpix.clamp(0, res_flat.shape[0] - 1).long()] \
        .to(torch.int32)
    out = torch.where((roff >= 0)[:, None, None],
                      (out + res).clamp(0, (1 << bd) - 1), out)

    # scatter (masked pixels -> trash slot n)
    fidx = torch.where(pixmask, fidx_raw, n)
    frame[fidx.reshape(-1).long()] = out.reshape(-1)


def scan_into(frame, packed, res_flat, pal_tensors, config, windows,
              levels):
    """Whole-batch wavefront scan, in place.

    frame: flat int32 [n + 1] buffer whose last slot is the trash slot;
    packed: {T: [Ncap, F] int32}; res_flat: packed residual pixels (int16
    for 8-bit); pal_tensors: {T: [P, T, T] int32}, all on one device.
    config: (((T, Bmax), ...), bd, sub_x, sub_y, eef[, has_inter]).
    windows: (ws, wc, flags) host arrays from `plan_windows`; levels:
    (table, lanes, tickets) from `plan_levels` and the tickets on the
    frame's device.  A CUDA frame runs the kernel (`levels`), a CPU
    frame the plain version (`windows`)."""
    dev = frame.device
    if dev.type == "cpu":
        _scan_plain(frame, packed, res_flat, pal_tensors, config, windows)
    elif dev.type == "cuda":
        _scan_kernel(frame, packed, res_flat, pal_tensors, config, levels)
    else:
        raise ValueError(f"scan_into: unsupported device {dev}")


def _scan_plain(frame, packed, res_flat, pal_tensors, config, windows):
    """The plain version of the scan: the window loop over
    `_apply_bucket`, on any device (`scan_into`'s arguments)."""
    (buckets, bd, sub_x, sub_y, eef, *_has_inter) = config
    ws, wc, flags = windows
    n = frame.shape[0] - 1
    c = _consts(frame.device)
    ws, wc, flags = ws.tolist(), wc.tolist(), flags.tolist()
    with no_device_sync(frame.device):
        for st, cn, fl in zip(ws, wc, flags):
            for bi, (T, _bmax) in enumerate(buckets):
                if cn[bi] == 0:
                    continue
                _apply_bucket(frame, n, packed[T][st[bi]:st[bi] + cn[bi]],
                              res_flat, pal_tensors[T], fl[bi], T=T, bd=bd,
                              sub_x=sub_x, sub_y=sub_y, eef=eef, c=c)


def _scan_kernel(frame, packed, res_flat, pal_tensors, config, levels):
    """The scan on the card: one `wavefront_scan` launch for a batch with
    lanes, counted in `launches`, its counter buffer kept in
    `last_scan`.  Raises on inputs the kernel does not take or a failed
    launch."""
    global launches, last_scan
    out = _launch("wavefront_scan", frame, packed, res_flat, pal_tensors,
                  config, levels)
    if out is not None:
        launches += 1
        last_scan = out


def _launch(entry, frame, packed, res_flat, pal_tensors, config, levels):
    """Launch C entry `entry` of `csrc/wavefront_scan.cu` (the scan, or
    `wavefront_scan_floor`, its protocol alone) on `scan_into`'s inputs,
    on the frame's device and its current stream, with a zeroed counter
    buffer of its own.  Returns (counters, lanes of each level with
    lanes), or None when the batch has no lane."""
    (buckets, bd, sub_x, sub_y, eef, *_has_inter) = config
    table_np, lanes, tickets_np, tickets = levels
    dev = frame.device
    ts = [t for t, _ in buckets]
    if not 1 <= len(ts) <= 3 or any(t not in (16, 32, 64) for t in ts):
        raise ValueError(f"scan_into: buckets {ts}, the kernel takes 1-3 "
                         f"of 16, 32, 64")
    want = {"frame": (frame, torch.int32),
            "tickets": (tickets, torch.int32)}
    for t in ts:
        want[f"rows {t}"] = (packed[t], torch.int32)
        want[f"palettes {t}"] = (pal_tensors[t], torch.int32)
    for name, (x, dt) in want.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"scan_into: {name} must be contiguous {dt} "
                             f"on {dev}, got {x.dtype} on {x.device}")
    if res_flat.device != dev or res_flat.dtype not in (torch.int16,
                                                        torch.int32) \
            or not res_flat.is_contiguous():
        raise ValueError(f"scan_into: residuals must be contiguous int16 "
                         f"or int32 on {dev}")
    total = int(lanes.sum())
    if any(packed[t].ndim != 2 or packed[t].shape[1] != len(_DEV_FIELDS)
           for t in ts) or table_np.shape != (len(lanes), len(ts), 2) or \
            tuple(tickets.shape) != (total, len(_TICKET)) or \
            tickets_np.shape != tuple(tickets.shape):
        raise ValueError("scan_into: lane rows must be [N, "
                         f"{len(_DEV_FIELDS)}], the level table "
                         f"[{len(lanes)}, {len(ts)}, 2] and the tickets "
                         f"[{total}, {len(_TICKET)}]")
    ends = table_np[:, :, 0].astype(np.int64) + table_np[:, :, 1]
    if len(lanes) and ((table_np < 0).any() or any(
            ends[:, bi].max() > packed[t].shape[0]
            for bi, t in enumerate(ts))):
        raise ValueError("scan_into: the level table names lanes beyond "
                         "the lane rows")
    if total == 0:
        return None
    bucket, row = tickets_np[:, 0], tickets_np[:, 1]
    rows_of = np.asarray([packed[t].shape[0] for t in ts])
    if bucket.min() < 0 or bucket.max() >= len(ts) or row.min() < 0 or \
            (row >= rows_of[np.minimum(bucket, len(ts) - 1)]).any():
        raise ValueError("scan_into: the tickets name lanes beyond the "
                         "lane rows")
    live = lanes[lanes > 0]
    with torch.cuda.device(dev):
        # the first `_consts` of a device uploads (a synchronising copy),
        # so the parameters are made before `launch`'s no-sync guard
        counters = torch.zeros((len(live) + 1) * COUNTER_STRIDE,
                               dtype=torch.int32, device=dev)
        params = _params(frame, packed, res_flat, pal_tensors, config,
                         tickets, counters)
    launch("wavefront_scan", entry, dev, params, total)
    return counters, live


def _params(frame, packed, res_flat, pal_tensors, config, tickets,
            counters):
    """The kernel's parameters in `_PARAMS` order: tensors where it takes
    a pointer, ints; a bucket the batch does not have is 0 throughout."""
    (buckets, bd, sub_x, sub_y, eef, *_has_inter) = config
    c = _consts(frame.device)
    params = dict(
        frame=frame, res=res_flat, tickets=tickets, counters=counters,
        kern=c["kern"], sm=c["sm"], fi_taps=c["fi_taps"],
        n=frame.shape[0] - 1, res_len=res_flat.shape[0],
        res_bytes=res_flat.element_size(), sm_len=_SM.shape[0],
        nb=len(buckets), bd=bd, sub_x=sub_x, sub_y=sub_y,
        eef=int(bool(eef)))
    for k, (t, _) in enumerate(buckets):
        params.update({f"rows{k}": packed[t], f"pal{k}": pal_tensors[t],
                       f"t{k}": t})
    return param_list(_PARAMS, params)


def levels_completed(scan=None):
    """The levels with lanes whose done counter reached their lanes in a
    launch's counter buffer (`scan`, as `_launch` returns it; default the
    last scan's, `last_scan`): every level, once the launch ran to its
    end.  Synchronises with the card."""
    counters, live = last_scan if scan is None else scan
    done = tracing.to_host(counters.view(-1, COUNTER_STRIDE)[1:, 0]).numpy()
    return int((done == live).sum())
