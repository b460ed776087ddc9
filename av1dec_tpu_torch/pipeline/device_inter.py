"""Host-side planning for the device inter path. [SPEC §7.11.3]

Copied from `av1dec_tpu.pipeline.device_inter`: decides per frame
whether EVERY inter block is expressible as device MC lanes
(translational, unscaled refs, SIMPLE motion mode, one reference list),
and if so extracts the lane schedule consumed by
`ops/kernels/mc.mc_into`: per prediction unit (block plane region or
sub-8x8 chroma piece) one row of MC_FIELDS with destination window,
packed-reference indexing, tap origins, filter rows, and compound
weights.  Frames with any exotic block (warp, OBMC, wedge/diffwtd,
inter-intra, intra-bc, scaled refs, global warp) are not on the device
path; `ineligible_reason` decides and names the tool.  Average and
distance-weighted compound blocks take two-list lanes (the MC pass
blends them in-lane); the distance weights are libaom's
(`ops/spec/inter.dist_weights`), which the reference's differ from.

`frame_eligible` and `_pack_refs` are the reference's.  `_build_lanes`
gives the reference's rows, but builds them for the whole frame with
array operations where the reference visits each block and plane, and
`_list_params` takes columns of lanes.  Also different: the reference's
`InterPlan.ref_flat` and `mc_config_and_lanes` become the functions
`pack_ref_flat` and `upload_lanes`, which take an explicit torch device
and either package's lanes and pieces (so `device_recon.to_torch_inputs`
uploads the JAX package's as well), and the JAX version's power-of-two
lane capacities (`_MC_CAPS`), which only keep its jit keys stable, are
left out: eager torch runs exact lane counts.
"""
from __future__ import annotations

import numpy as np
import torch

from av1dec_tpu_torch import tracing
from av1dec_tpu_torch.ops.kernels.mc import MC_FIELDS, _MF
from av1dec_tpu_torch.ops.spec import inter as I

BLOCK_W4 = [1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32,
            1, 4, 2, 8, 4, 16]
BLOCK_H4 = [1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32,
            4, 1, 8, 2, 16, 4]
INTRA_FRAME = 0
GLOBALMV = 15
GLOBAL_GLOBALMV = 23

MC_BUCKETS = (4, 8, 16, 32, 64, 128)
_W4 = np.asarray(BLOCK_W4)
_H4 = np.asarray(BLOCK_H4)
_REFS = 8  # reference frame numbers, INTRA_FRAME included
# I.filter_index as a table: [interp filter, dimension <= 4]
_FILTER_INDEX = np.asarray([[I.filter_index(f, 8), I.filter_index(f, 4)]
                            for f in range(16)])


def _bucket_for(w, h):
    """The side of the smallest MC bucket that holds a w x h unit, the
    largest for a larger one (w and h may be arrays)."""
    i = np.searchsorted(MC_BUCKETS, np.maximum(w, h))
    return np.asarray(MC_BUCKETS)[np.minimum(i, len(MC_BUCKETS) - 1)]


def frame_eligible(hdr, plans, refs, num_planes):
    """True when every inter block maps onto device MC lanes."""
    g = plans.grid
    inter = np.asarray(g("is_inter")) != 0
    if not inter.any():
        return True
    if refs is None:
        return False
    if np.asarray(g("intrabc")).any():
        return False
    if (np.asarray(g("motion_mode"))[inter] != 0).any():
        return False  # OBMC / warped-causal
    if (np.asarray(g("interintra"))[inter] != 0).any():
        return False
    if (np.asarray(g("compound_type"))[inter] > 1).any():
        return False  # wedge / diffwtd
    ref0 = np.asarray(g("ref0"))
    ref1 = np.asarray(g("ref1"))
    # any used reference at a different size -> scaled MC (host path)
    used = set(np.unique(ref0[inter]).tolist()) | \
        set(np.unique(ref1[inter & (ref1 > INTRA_FRAME)]).tolist())
    used.discard(INTRA_FRAME)
    used.discard(-1)
    for r in used:
        ent = refs.get(int(r))
        if ent is None:
            return False
        if ent["width"] != hdr["frame_width"] or \
                ent["height"] != hdr["frame_height"]:
            return False
    # global-warp trigger: GLOBAL modes with a >translation gm on a
    # >=8x8 block [SPEC §7.11.3.1 useWarp]
    gm_type = np.asarray((hdr.get("gm") or {}).get("type", [0] * 8))
    mode = np.asarray(g("mode"))
    bsz = np.asarray(g("bsize"))
    bw = np.asarray(BLOCK_W4)[bsz] * 4
    bh = np.asarray(BLOCK_H4)[bsz] * 4
    glob = inter & np.isin(mode, (GLOBALMV, GLOBAL_GLOBALMV)) & \
        (np.minimum(bw, bh) >= 8)
    if (gm_type[np.clip(ref0, 0, 7)][glob] > 1).any():
        return False
    g2 = glob & (mode == GLOBAL_GLOBALMV) & (ref1 > INTRA_FRAME)
    if (gm_type[np.clip(ref1, 0, 7)][g2] > 1).any():
        return False
    return True


def ineligible_reason(hdr, plans, refs, num_planes):
    """The port's eligibility policy: None when the device MC path takes
    the frame, else the inter tool that keeps it off (checked in
    frame_eligible's order), the same frames `frame_eligible` refuses.
    A frame `frame_eligible` refuses for a reason not named here gets a
    neutral one."""
    g = plans.grid
    inter = np.asarray(g("is_inter")) != 0
    if not inter.any():
        return None
    if refs is None:
        return "inter frame without reference frames"
    if np.asarray(g("intrabc")).any():
        return "intra block copy frame"
    motion = np.asarray(g("motion_mode"))[inter]
    if (motion == 1).any():
        return "inter frame with OBMC"
    if (motion != 0).any():
        return "inter frame with local warped motion"
    if (np.asarray(g("interintra"))[inter] != 0).any():
        return "inter frame with inter-intra prediction"
    if (np.asarray(g("compound_type"))[inter] > 1).any():
        return "inter frame with wedge or difference-weighted compound"
    ref0 = np.asarray(g("ref0"))
    ref1 = np.asarray(g("ref1"))
    used = np.union1d(ref0[inter & (ref0 > INTRA_FRAME)],
                      ref1[inter & (ref1 > INTRA_FRAME)])
    for r in used.tolist():
        ent = refs.get(r)
        if ent is None:
            return "inter frame with a missing reference frame"
        if (ent["width"], ent["height"]) != (hdr["frame_width"],
                                             hdr["frame_height"]):
            return "inter frame with a scaled reference"
    # [SPEC §7.11.3.1 useWarp]: GLOBALMV or GLOBAL_GLOBALMV on a >= 8x8
    # block whose reference (either one, for the compound mode) has a
    # more than translational global motion
    gm_type = np.asarray((hdr.get("gm") or {}).get("type", [0] * 8))
    bsz = np.asarray(g("bsize"))
    mode = np.asarray(g("mode"))
    glob = inter & np.isin(mode, (GLOBALMV, GLOBAL_GLOBALMV)) & \
        (np.minimum(np.asarray(BLOCK_W4)[bsz], np.asarray(BLOCK_H4)[bsz])
         >= 2)
    glob1 = glob & (mode == GLOBAL_GLOBALMV) & (ref1 > INTRA_FRAME)
    if (gm_type[np.clip(ref0, 0, 7)][glob] > 1).any() or \
            (gm_type[np.clip(ref1, 0, 7)][glob1] > 1).any():
        return "inter frame with global warp motion"
    if not frame_eligible(hdr, plans, refs, num_planes):
        return "inter tool outside the MC lanes"
    return None


def pack_ref_flat(pieces, device):
    """Concatenate the reference pieces (host arrays or tensors of the
    decoder's device reference cache) into one flat tensor on `device`.
    High-bit-depth pieces are widened to int32 first, as the gather
    would after reading them.  Its bytes count in `refs.bytes`."""
    flat = []
    for p in pieces:
        t = tracing.to_device(p, device).reshape(-1)
        flat.append(t if t.dtype == torch.uint8 else t.to(torch.int32))
    out = torch.cat(flat)
    tracing.count("refs.bytes", out.nbytes)
    return out


def upload_lanes(lanes, bd, device, base_off=0):
    """(config, {(T, comp): device rows}) of a lane dict of either
    package's InterPlan ({(T, comp): [N, F] int rows}): one upload,
    exact lane counts, buckets in sorted key order (the JAX run_mc's
    order), destination bases moved by `base_off` (the frame's offset
    in a batch's flat buffer)."""
    keys = [k for k in sorted(lanes) if len(lanes[k])]
    if not keys:
        return ((), bd), {}
    rows = np.concatenate([lanes[k] for k in keys]).astype(np.int32)
    rows[:, _MF["base"]] += base_off
    dev = tracing.to_device(rows, device)
    out, buckets, s = {}, [], 0
    for k in keys:
        n = len(lanes[k])
        out[k] = dev[s:s + n]
        buckets.append((k[0], k[1], n))
        s += n
    return (tuple(buckets), bd), out


class InterPlan:
    """Lane schedule + packed reference buffer for one frame."""

    def __init__(self, seq, hdr, plans, refs, sch):
        self.sch = sch
        self.bd = sch.bd
        with tracing.span("inter_plan.refs"):
            self.ref_np, self._layout = self._pack_refs(seq, hdr, refs,
                                                        plans, sch)
        with tracing.span("inter_plan.lanes"):
            self.lanes = self._build_lanes(seq, hdr, plans, sch)

    # -- packed reference buffer ------------------------------------------
    def _pack_refs(self, seq, hdr, refs, plans, sch):
        """Reference pieces + flat layout.  Pieces stay as separate
        arrays (host np OR device arrays from the decoder's device ref
        cache — frames decoded on device never round-trip their ref
        pixels over the link); ref_flat() concatenates on device."""
        g = plans.grid
        inter = np.asarray(g("is_inter")) != 0
        ref0 = np.asarray(g("ref0"))
        ref1 = np.asarray(g("ref1"))
        used = set(np.unique(ref0[inter]).tolist()) | \
            set(np.unique(ref1[inter & (ref1 > INTRA_FRAME)]).tolist())
        used.discard(INTRA_FRAME)
        used.discard(-1)
        dt = np.uint8 if sch.bd == 8 else np.uint16
        pieces, layout, off = [], {}, 0
        for r in sorted(int(v) for v in used):
            ent = refs[r]
            dev = ent.get("dev_planes")
            for pl in range(sch.num_planes):
                ssx = sch.sub_x if pl else 0
                ssy = sch.sub_y if pl else 0
                if dev is not None:
                    p = dev[pl]
                else:
                    p = np.ascontiguousarray(ent["planes"][pl], dt)
                lastx = ((ent["width"] + ssx) >> ssx) - 1
                lasty = ((ent["height"] + ssy) >> ssy) - 1
                layout[(r, pl)] = (off, p.shape[1], lastx, lasty)
                pieces.append(p)
                off += int(np.prod(p.shape))
        if not pieces:
            pieces = [np.zeros(1, dt)]
        return pieces, layout

    # -- lane schedule ----------------------------------------------------
    def _list_params(self, plane, px, py, pw, ph, mv_row, mv_col, ref,
                     interp, ssx, ssy):
        """One reference list's fields (rb, rs, lx, ly, cx, cy, hf, vf)
        of lanes given as int64 columns: int64 [n, 8]."""
        lay = np.zeros((_REFS, self.sch.num_planes, 4), np.int64)
        have = np.zeros(lay.shape[:2], bool)
        for (r, pl), v in self._layout.items():
            lay[r, pl] = v
            have[r, pl] = True
        known = (ref >= 0) & (ref < _REFS)
        ref = np.where(known, ref, 0)
        if not (known & have[ref, plane]).all():
            raise KeyError("a lane's reference has no packed plane")
        sx, sy, _, _ = I.mv_scaling(px, py, mv_row, mv_col, ssx, ssy,
                                    1 << 14, 1 << 14)
        hf = _FILTER_INDEX[(interp >> 4) & 15, (pw <= 4).astype(np.int64)] \
            * 16 + ((sx >> 6) & 15)
        vf = _FILTER_INDEX[interp & 15, (ph <= 4).astype(np.int64)] * 16 + \
            ((sy >> 6) & 15)
        return np.column_stack((lay[ref, plane], (sx >> 10) - 3,
                                (sy >> 10) - 3, hf, vf))

    def _build_lanes(self, seq, hdr, plans, sch):
        """{(T, comp): int64 [N, len(MC_FIELDS)]}: a row per prediction
        unit (a block's plane, or a piece of a sub-8x8 block's chroma
        [SPEC §7.11.1]), in block raster order, then plane, then piece,
        built for all of the frame's inter blocks at once.  List 1's
        fields and the weights of a single-reference lane are 0."""
        g = plans.grid
        mi_rows, mi_cols = plans.mi_rows, plans.mi_cols
        # each inter block's top-left: the inter mi whose (by, bx) is
        # its own position, in raster order
        own = (np.asarray(g("is_inter")) != 0) & \
            (np.asarray(g("by")) == np.arange(mi_rows)[:, None]) & \
            (np.asarray(g("bx")) == np.arange(mi_cols))
        by, bx = np.nonzero(own)
        bsize = np.asarray(g("bsize"))[by, bx]
        bw4, bh4 = _W4[bsize], _H4[bsize]
        sub_x, sub_y = sch.sub_x, sch.sub_y
        # prediction units (block, plane) in block order: luma of every
        # block, chroma of the blocks that carry it
        units = np.ones((len(by), sch.num_planes), bool)
        units[:, 1:] = ((((by & 1) == 1) | ((bh4 & 1) == 0) | (not sub_y)) &
                        (((bx & 1) == 1) | ((bw4 & 1) == 0) | (not sub_x))
                        )[:, None]
        blk, plane = np.nonzero(units)
        uy, ux, w4, h4 = by[blk], bx[blk], bw4[blk], bh4[blk]
        ssx = np.where(plane > 0, sub_x, 0)
        ssy = np.where(plane > 0, sub_y, 0)
        row0 = np.where((ssy > 0) & (h4 == 1), uy & ~1, uy)
        col0 = np.where((ssx > 0) & (w4 == 1), ux & ~1, ux)
        # a chroma unit moved up or left is cut into one piece per
        # covering mi, each from that mi's own mv/ref/filter, unless one
        # of the mi it covers is intra [SPEC §7.11.1]
        cells = (row0 != uy) | (col0 != ux)
        moved = np.nonzero(cells)[0]
        if len(moved):
            ref0_g = np.asarray(g("ref0"))
            r0, c0 = row0[moved], col0[moved]
            hh = uy[moved] + h4[moved] - r0
            ww = ux[moved] + w4[moved] - c0
            intra = np.zeros(len(moved), bool)
            for dy in range(int(hh.max())):
                for dx in range(int(ww.max())):
                    cover = (dy < hh) & (dx < ww)
                    mr = np.minimum(r0 + dy, mi_rows - 1)
                    mc = np.minimum(c0 + dx, mi_cols - 1)
                    intra |= cover & (ref0_g[mr, mc] <= INTRA_FRAME)
            cells[moved] = ~intra
        pw = ((ux + w4 - col0) * 4) >> ssx
        ph = ((uy + h4 - row0) * 4) >> ssy
        # each unit's pieces, up to 2x2 of its prediction size; a unit
        # not cut is one piece of its whole size
        pred_w = np.where(cells, (w4 * 4) >> ssx, pw)
        pred_h = np.where(cells, (h4 * 4) >> ssy, ph)
        jy, jx = np.divmod(np.arange(4), 2)
        yy = jy * pred_h[:, None]
        xx = jx * pred_w[:, None]
        u, k = np.nonzero((yy < ph[:, None]) & (xx < pw[:, None]))
        yy, xx = yy[u, k], xx[u, k]
        pl, sx_, sy_, cut = plane[u], ssx[u], ssy[u], cells[u]
        x = ((col0[u] * 4) >> sx_) + xx
        y = ((row0[u] * 4) >> sy_) + yy
        w, h = pred_w[u], pred_h[u]
        mr = np.where(cut, row0[u] + ((yy << sy_) >> 2), uy[u])
        mc = np.where(cut, col0[u] + ((xx << sx_) >> 2), ux[u])
        tracing.count("lanes.rows", len(u))
        tracing.count("lanes.pieces", int(np.count_nonzero(cut)))

        def at(name):
            return np.asarray(g(name))[mr, mc].astype(np.int64)

        ref0, ref1, interp = at("ref0"), at("ref1"), at("interp")
        comp = ref1 > INTRA_FRAME
        rows = np.zeros((len(u), len(MC_FIELDS)), np.int64)
        for f, v in (("x", x), ("y", y), ("w", w), ("h", h),
                     ("base", np.asarray(sch.plane_base, np.int64)[pl]),
                     ("stride", np.asarray([d[1] for d in sch.alloc_dims],
                                           np.int64)[pl])):
            rows[:, _MF[f]] = v
        rows[:, _MF["rb0"]:_MF["vf0"] + 1] = self._list_params(
            pl, x, y, w, h, at("mv0y"), at("mv0x"), ref0, interp, sx_, sy_)
        c = np.nonzero(comp)[0]
        if len(c):
            mv1y, mv1x = at("mv1y")[c], at("mv1x")[c]
            rows[c, _MF["rb1"]:_MF["vf1"] + 1] = self._list_params(
                pl[c], x[c], y[c], w[c], h[c], mv1y, mv1x, ref1[c],
                interp[c], sx_[c], sy_[c])
            self._compound_weights(rows, c, ref0[c], ref1[c],
                                   at("compound_type")[c], hdr, sch.bd)
        key = _bucket_for(w, h) * 2 + comp
        kinds, first = np.unique(key, return_index=True)
        return {(int(k) >> 1, int(k) & 1): rows[key == k]
                for k in kinds[np.argsort(first)]}

    @staticmethod
    def _compound_weights(rows, c, ref0, ref1, ctype, hdr, bd):
        """w0, w1 and bshift of the compound lanes `c`: distance weights
        (libaom's, per (ref0, ref1) pair) where `ctype` is 1, else the
        average."""
        post = 14 - (5 if bd == 12 else 3) - 7
        order_hint = hdr.get("order_hint", 0)
        order_hints = hdr.get("order_hints", [0] * 8)
        hint_bits = hdr.get("order_hint_bits", 0)
        enable_hint = hdr.get("enable_order_hint_seq", 0)

        def dist(ref):
            if not enable_hint:
                return 0
            diff = order_hints[ref] - order_hint
            m = 1 << (hint_bits - 1)
            return min(I.MAX_FRAME_DISTANCE,
                       abs((diff & (m - 1)) - (diff & m)))

        dw = ctype == 1
        pair = ref0 * _REFS + ref1
        wts = np.ones((len(c), 2), np.int64)
        for p in np.unique(pair[dw]).tolist():
            wts[dw & (pair == p)] = I.dist_weights(dist(p % _REFS),
                                                   dist(p // _REFS))
        rows[c, _MF["w0"]] = wts[:, 0]
        rows[c, _MF["w1"]] = wts[:, 1]
        rows[c, _MF["bshift"]] = np.where(dw, post + 4, post + 1)
