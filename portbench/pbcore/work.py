"""The bytes and operations each kernel launch needs, the card's peaks,
and the bound of a launch: the least time the card could take for it.

The arithmetic is a frozen copy of the port's `chip_smoke.py` (`*_work`,
`bound_terms`), of the direction search of `ops/kernels/cdef.py` and of
the plain deblock (`deblock_plain.py`), so that a later change to the
program cannot move the yardstick.  The row layouts of the lane tables
that the scan and MC kernels take are frozen here too (`DEV_FIELDS`,
`MC_FIELDS`): `Recorder` compares them with the program's on entering,
and where one differs it reads no bound at all and says so
(`LayoutChanged`), rather than read the wrong columns.

`Recorder` patches the calls that launch the kernels, in the namespace
each is called from, and adds up the bound of every call that launched
its kernel."""
import numpy as np

from pbcore import deblock_plain

# the columns of a scan lane row (`ops/kernels/wavefront.py` _DEV_FIELDS)
# and of an MC lane row (`ops/kernels/mc.py` MC_FIELDS)
DEV_FIELDS = (
    "x", "y", "plane", "base", "stride", "mode_family", "p_angle",
    "above_case", "above_lim", "left_case", "left_lim", "corner_case",
    "str_above", "str_left", "up_above", "up_left", "npx_above", "npx_left",
    "corner_filt", "dx", "dy", "have_above", "have_left", "res_idx",
    "pal_idx", "fi_mode", "cfl_alpha", "cfl_maxx", "cfl_maxy", "dc_case",
    "w", "h", "lw", "lh", "lbase")
MC_FIELDS = (
    "x", "y", "base", "stride", "w", "h",
    "rb0", "rs0", "lx0", "ly0", "cx0", "cy0", "hf0", "vf0",
    "rb1", "rs1", "lx1", "ly1", "cx1", "cy1", "hf1", "vf1",
    "w0", "w1", "bshift")


class LayoutChanged(RuntimeError):
    """The program's lane rows no longer have the frozen columns."""


def program_layouts():
    """{name: (frozen columns, the program's)} of the two lane tables."""
    from av1dec_tpu_torch.ops.kernels import mc, wavefront
    return {"scan lane rows": (DEV_FIELDS, tuple(wavefront._DEV_FIELDS)),
            "MC lane rows": (MC_FIELDS, tuple(mc.MC_FIELDS))}


def check_layouts():
    for name, (frozen, now) in program_layouts().items():
        if frozen != now:
            raise LayoutChanged(
                f"the program's {name} are {now}, the bound's arithmetic "
                f"reads {frozen}")

# H100 SXM data sheet: HBM3 rate
HBM_BYTES_PER_S = 3.35e12
# H100 SXM data sheet: dense int8 tensor-core rate
INT8_OPS_PER_S = 1.979e15
# int32 add, compare, min/max, shift and multiply-add results per clock
# per SM at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), x 132 SMs x the H100 SXM's
# published maximum SM clock of 1,980 MHz: worked out from published
# numbers, not measured
INT32_PER_CLOCK_PER_SM = 64
SMS = 132
MAX_SM_MHZ = 1980
INT32_OPS_PER_S = INT32_PER_CLOCK_PER_SM * SMS * MAX_SM_MHZ * 1e6

# CDEF: per tap that is on, and per filtered pixel; the direction search
# of one 8x8 unit in int32 and its partial sums in int8 (multiply-adds)
CDEF_OPS_PER_TAP = 12
CDEF_OPS_PER_PX = 8
DIR_OPS_PER_UNIT = 64 * 2 + 8 * 30 + 16
DIR_INT8_OPS_PER_UNIT = 8 * 64 * 2
# wavefront scan: per written pixel the residual add and clip, by mode
# family its prediction, CfL on DC
SCAN_OPS_PER_PX = 3
SCAN_FAMILY_OPS = {7: 13, 4: 10, 5: 5, 6: 5, 3: 12, 9: 18}
SCAN_CFL_OPS_PER_PX = 14
# deblock: per edge line by its length its decision, then by the filter
# that runs
DEBLOCK_DECISION_OPS = {4: 2 + 16, 6: 2 + 16 + 8 + 11 + 2,
                        8: 2 + 16 + 8 + 11 + 2 + 8 + 8,
                        14: 2 + 16 + 8 + 11 + 2 + 8 + 8 + 24}
DEBLOCK_OPS = {"wide": 15 + 11 * 4 + 12 * 2, "8": 6 + 5 * 4 + 6 * 2,
               "6": 6 + 3 * 4 + 4 * 2, "4": 53}
# Wiener: per output pixel of a unit that is on, and per horizontally
# filtered pixel; superres: per output pixel
SEP_OPS_PER_PX = 7 + 2 + 2
SUPERRES_OPS_PER_PX = 8 + 2 + 2
# transform sizes (w, h) by tx_size, and (column kind, row kind) by
# tx_type, kind 0 DCT, 1 ADST, 2 identity [SPEC §7.13]
TX_DIMS = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
           (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32),
           (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]
TX_KINDS = {0: (0, 0), 1: (1, 0), 2: (0, 1), 3: (1, 1), 4: (1, 0),
            5: (0, 1), 6: (1, 1), 7: (1, 1), 8: (1, 1), 9: (2, 2),
            10: (0, 2), 11: (2, 0), 12: (1, 2), 13: (2, 1), 14: (1, 2),
            15: (2, 1)}
# int32 operations of one n-point 1-D transform of the spec model (its
# adds, multiplies and shifts), counted once on counting operands
TRANSFORM_OPS = {(0, 4): 24, (0, 8): 67, (0, 16): 183, (0, 32): 475,
                 (0, 64): 1179, (1, 4): 26, (1, 8): 100, (1, 16): 256,
                 (2, 4): 12, (2, 8): 8, (2, 16): 64, (2, 32): 32}
# CDEF's direction search: cost divisors [SPEC §7.15.2]
DIV_TABLE = (840, 420, 280, 210, 168, 140, 120, 105)


def bound_s(nbytes, ops, int8_ops=0):
    """Seconds of the larger of the bytes term and the operations
    term."""
    return max(nbytes / HBM_BYTES_PER_S,
               ops / INT32_OPS_PER_S + int8_ops / INT8_OPS_PER_S)


def _proj():
    p = np.zeros((8, 64, 15), np.float32)
    for i in range(8):
        for j in range(8):
            for d, idx in enumerate([
                    i + j, i + (j >> 1), i, 3 + i - (j >> 1),
                    7 + i - j, 3 - (i >> 1) + j, j, (i >> 1) + j]):
                p[d, i * 8 + j, idx] = 1
    return p.transpose(1, 0, 2).reshape(64, 120)


def directions_var(luma, bd):
    """The direction search's variance of each 8x8 unit of `luma` [H, W]
    (multiples of 8) [SPEC §7.15.2]."""
    import torch
    H, W = luma.shape
    x = (luma.to(torch.int32) >> (bd - 8)) - 128
    blocks = x.reshape(H // 8, 8, W // 8, 8).permute(0, 2, 1, 3) \
        .reshape(-1, 64)
    proj = torch.as_tensor(_proj(), device=luma.device)
    partial = (blocks.to(torch.float32) @ proj).round().to(torch.int64) \
        .reshape(-1, 8, 15)
    p2 = partial * partial
    div = torch.as_tensor(DIV_TABLE, dtype=torch.int64, device=luma.device)
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
    k = torch.arange(8, dtype=torch.int64, device=luma.device)
    best = ((cost << 3) + (7 - k)).argmax(1)
    c_best = cost.gather(1, best[:, None])[:, 0]
    c_orth = cost.gather(1, ((best + 4) & 7)[:, None])[:, 0]
    return ((c_best - c_orth) >> 10).to(torch.int32).reshape(H // 8, W // 8)


def ilog2(v):
    """floor(log2(max(v, 1))) for 0 <= v < 2^13."""
    import torch
    out = torch.zeros_like(v)
    for k in range(1, 13):
        out = out + (v >= (1 << k)).to(torch.int32)
    return out


def filter_ops(apply, pri_on, sec_on, px):
    import torch
    taps = 4 * pri_on.long() + 8 * sec_on.long()
    per_px = torch.where(apply, CDEF_OPS_PER_PX + CDEF_OPS_PER_TAP * taps,
                         torch.zeros_like(taps))
    return int(per_px.sum()) * px


def cdef_work(planes, gates, bd, subx, suby):
    """(bytes, int32 operations, int8 operations) of CDEF of one frame:
    the planes read once and written once, the strengths read once; the
    direction search of each unit with a primary strength, and the taps
    that are on in each unit with something to apply."""
    import torch
    y_pri, y_sec, uv_pri, uv_sec = gates
    chroma = len(planes) > 1
    var = directions_var(planes[0], bd)
    pri_adj = torch.where((y_pri > 0) & (var != 0),
                          (y_pri * (4 + ilog2(var >> 6)) + 8) >> 4, 0)
    ops = filter_ops((pri_adj > 0) | (y_sec > 0), pri_adj > 0, y_sec > 0, 64)
    search = y_pri > 0
    if chroma:
        ops += filter_ops((uv_pri > 0) | (uv_sec > 0), uv_pri > 0,
                          uv_sec > 0, 2 * (64 >> (subx + suby)))
        search = search | (uv_pri > 0)
    searched = int(search.sum())
    ops += searched * DIR_OPS_PER_UNIT
    nbytes = 2 * sum(4 * p.numel() for p in planes) + \
        (4 if chroma else 2) * 4 * y_pri.numel()
    return nbytes, ops, searched * DIR_INT8_OPS_PER_UNIT


def scan_work(packed, res, config):
    """(bytes, int32 operations) of one batch's scan: the lane rows read
    once; each lane's residual, palette map or MC prediction read once,
    its pixels written once, the edge pixels its family reads and CfL's
    co-located luma; per pixel its family's operations."""
    F = {name: i for i, name in enumerate(DEV_FIELDS)}
    sub = 1 << (config[2] + config[3])
    nbytes = ops = 0
    for rows in packed.values():
        r = rows.cpu().numpy().astype(np.int64)
        w, h, mf = r[:, F["w"]], r[:, F["h"]], r[:, F["mode_family"]]
        wh = w * h
        cfl = (mf == 0) & (r[:, F["cfl_maxx"]] > 0)
        intra = (mf != 8) & (mf != 10)
        edge = np.where(mf == 3, 2 * (w + h), w + h) + 1
        nbytes += 4 * (r.size + wh.sum() + (wh * (mf == 8)).sum() +
                       (wh * (mf == 10)).sum() + (edge * intra).sum() +
                       sub * (wh * cfl).sum())
        nbytes += res.element_size() * \
            (wh * (r[:, F["res_idx"]] >= 0)).sum()
        fam = np.zeros_like(mf)
        for m, k in SCAN_FAMILY_OPS.items():
            fam[mf == m] = k
        ops += ((SCAN_OPS_PER_PX + fam + SCAN_CFL_OPS_PER_PX * cfl) *
                wh).sum()
        ops += ((w + h) * (mf == 0)).sum() + (24 * (w + h) * (mf == 3)).sum()
    return int(nbytes), int(ops)


def mc_work(ref_flat, lanes, cfg):
    """(bytes, int32 operations) of one MC pass: each predicted pixel's
    reference read per list and its write, the lane rows read once; the
    8-tap multiply-adds of both passes."""
    F = {name: i for i, name in enumerate(MC_FIELDS)}
    nbytes = ops = 0
    for (T, comp, _n) in cfg[0]:
        rows = lanes[(T, comp)].cpu().long()
        w, h = rows[:, F["w"]], rows[:, F["h"]]
        lists = 1 + comp
        nbytes += int((w * h).sum()) * (lists * ref_flat.element_size() + 4)
        nbytes += rows.numel() * 4
        ops += lists * 8 * int((w * (2 * h + 7)).sum())
    return nbytes, ops


def residual_work(buf, spans):
    """(bytes, int32 operations) of one packed residual call: the packed
    buffer read once, the int32 residuals written once; per coded level
    the dequantizer, per pixel the scale, clamps and roundings, and each
    row's and column's 1-D transform."""
    nbytes = buf.numel() * buf.element_size()
    ops = 0
    for tsz, tt, _, B, _, _ in spans:
        w, h = TX_DIMS[tsz]
        ck, rk = TX_KINDS[tt]
        rect = (w.bit_length() - h.bit_length()) % 2
        per = (7 * min(w, 32) * min(h, 32) + w * h * (3 * rect + 8) +
               h * TRANSFORM_OPS[(rk, w)] + w * TRANSFORM_OPS[(ck, h)])
        ops += B * per
        nbytes += 4 * B * w * h
    return int(nbytes), int(ops)


def deblock_work(planes, maps, sharp, bd):
    """(bytes, int32 operations) of one frame's deblock: each plane and
    cell map read once, each output written once; per pass the decision
    of each edge line with a length and the filter each runs, from the
    frozen plain deblock on the pass's input (`deblock_plain`)."""
    _, kinds = deblock_plain.deblock(planes, maps, sharp, bd)
    ops = sum(kinds[f"len{L}"] * n for L, n in DEBLOCK_DECISION_OPS.items()) \
        + sum(kinds[k] * DEBLOCK_OPS[k] for k in DEBLOCK_OPS)
    nbytes = sum(8 * p.numel() for p in planes) + \
        sum(4 * m.numel() for pm in maps for pair in pm for m in pair)
    return nbytes, ops


def wiener_work(planes, pre_planes, lr_args):
    """(bytes, int32 operations) of the Wiener pass: each post-CDEF plane
    read once, the pre-CDEF rows a tap reads, the arguments read and the
    output written once; the horizontal pass over each distinct (plane,
    source row, unit row) the unit-on pixels need, the vertical pass over
    those pixels."""
    import torch
    nbytes = ops = 0
    for plane, a in zip(planes, lr_args):
        if a is None:
            continue
        uy, ux, tv, th, act, vr, inside = a
        H, W = plane.shape
        on = act.bool()[uy.long()][:, ux.long()]
        rows = on.any(1)
        key = ((~inside).long() * H + vr.long()) * act.shape[0] + \
            uy.long()[None, :]
        cols = int(on.any(0).sum())
        nbytes += 8 * plane.numel() + \
            4 * W * torch.unique(vr[~inside]).numel() + \
            sum(t.numel() * t.element_size() for t in a)
        ops += SEP_OPS_PER_PX * (int(on.sum()) + cols * torch.unique(
            key[:, rows]).numel())
    return nbytes, ops


def superres_work(planes, sr_args, outs):
    """(bytes, int32 operations) of an upscale: each source plane and
    table read once, each output written once; 8 taps an output
    pixel."""
    px = sum(o.numel() for o in outs)
    nbytes = sum(4 * p.numel() for p in planes) + 4 * px + \
        sum(4 * (c.numel() + t.numel()) for c, t in sr_args)
    return nbytes, px * SUPERRES_OPS_PER_PX


class Recorder:
    """Inside `with`: the bound of every call that launched one of the
    kernels, by kernel name (`bound` seconds, `calls`).  A call that
    launched nothing (an MC pass with no lanes, a scan with no lanes)
    adds nothing."""

    def __init__(self):
        self.bound = {}
        self.calls = {}
        self._undo = []

    def _add(self, kernel, launched, work):
        if launched:
            nbytes, ops, *int8 = work()
            self.bound[kernel] = self.bound.get(kernel, 0.0) + \
                bound_s(nbytes, ops, *int8)
            self.calls[kernel] = self.calls.get(kernel, 0) + 1

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, fn)

    def __enter__(self):
        check_layouts()
        from av1dec_tpu_torch.ops.kernels import (cdef, deblock, itx, lr,
                                                  mc, superres, wavefront)
        from av1dec_tpu_torch.pipeline import device_recon, recon
        dr = device_recon.__dict__
        rc = recon.__dict__
        cd = cdef.__dict__
        add = self._add

        def scan_into(frame, packed, res, pal, config, windows, levels):
            b = wavefront.launches
            out = dr_real["scan_into"](frame, packed, res, pal, config,
                                       windows, levels)
            add("wavefront_scan", wavefront.launches > b,
                lambda: scan_work(packed, res, config))
            return out

        def mc_into(frame, ref_flat, lanes, cfg):
            b = mc.launches
            out = dr_real["mc_into"](frame, ref_flat, lanes, cfg)
            add("mc", mc.launches > b, lambda: mc_work(ref_flat, lanes, cfg))
            return out

        def residuals_packed(buf, spans, words, bd):
            b = itx.launches
            out = rc_real["residuals_packed"](buf, spans, words, bd)
            add("itx", itx.launches > b, lambda: residual_work(buf, spans))
            return out

        def deblock_planes(planes, maps, sharp, bd):
            b = deblock.launches
            out = dr_real["deblock_planes"](planes, maps, sharp, bd)
            add("deblock", deblock.launches > b,
                lambda: deblock_work(planes, maps, sharp, bd))
            return out

        def superres_planes(planes, sr_args, bd):
            b = superres.launches
            out = dr_real["superres_planes"](planes, sr_args, bd)
            add("superres", superres.launches > b,
                lambda: superres_work(planes, sr_args, out))
            return out

        def lr_wiener_planes(planes, pre, lr_args, bd):
            b = lr.launches
            out = dr_real["lr_wiener_planes"](planes, pre, lr_args, bd)
            add("wiener", lr.launches > b,
                lambda: wiener_work(planes, pre, lr_args))
            return out

        def cdef_frame(planes, y_pri, y_sec, uv_pri, uv_sec, bd, damping,
                       subx, suby):
            b = cdef.frame_launches
            out = cd_real["cdef_frame"](planes, y_pri, y_sec, uv_pri,
                                        uv_sec, bd, damping, subx, suby)
            add("cdef_frame", cdef.frame_launches > b,
                lambda: cdef_work(planes, (y_pri, y_sec, uv_pri, uv_sec),
                                  bd, subx, suby))
            return out

        dr_real = {k: dr[k] for k in ("scan_into", "mc_into",
                                      "deblock_planes", "superres_planes",
                                      "lr_wiener_planes")}
        rc_real = {"residuals_packed": rc["residuals_packed"]}
        cd_real = {"cdef_frame": cd["cdef_frame"]}
        for name, fn in (("scan_into", scan_into), ("mc_into", mc_into),
                         ("deblock_planes", deblock_planes),
                         ("superres_planes", superres_planes),
                         ("lr_wiener_planes", lr_wiener_planes)):
            self._patch(device_recon, name, fn)
        self._patch(recon, "residuals_packed", residuals_packed)
        self._patch(cdef, "cdef_frame", cdef_frame)
        return self

    def __exit__(self, *_):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo = []
        return False
