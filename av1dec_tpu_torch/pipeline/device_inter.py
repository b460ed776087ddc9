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

`frame_eligible`, `_pack_refs`, `_list_params` and `_build_lanes` are
the reference's.  What differs: the reference's `InterPlan.ref_flat`
and `mc_config_and_lanes` become the functions `pack_ref_flat` and
`upload_lanes`, which take an explicit torch device and either
package's lanes and pieces (so `device_recon.to_torch_inputs` uploads
the JAX package's as well), and the JAX version's power-of-two lane
capacities (`_MC_CAPS`), which only keep its jit keys stable, are left
out: eager torch runs exact lane counts.
"""
from __future__ import annotations

import numpy as np
import torch

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


def _bucket_for(w, h):
    m = max(w, h)
    for t in MC_BUCKETS:
        if m <= t:
            return t
    return 128


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
    would after reading them."""
    flat = []
    for p in pieces:
        t = torch.as_tensor(p, device=device).reshape(-1)
        flat.append(t if t.dtype == torch.uint8 else t.to(torch.int32))
    return torch.cat(flat)


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
    dev = torch.as_tensor(rows, device=device)
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
        self.ref_np, self._layout = self._pack_refs(seq, hdr, refs,
                                                    plans, sch)
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
        rb, rs, lastx, lasty = self._layout[(ref, plane)]
        sx, sy, _, _ = I.mv_scaling(px, py, mv_row, mv_col, ssx, ssy,
                                    1 << 14, 1 << 14)
        cx = (sx >> 10) - 3
        cy = (sy >> 10) - 3
        hf = I.filter_index((interp >> 4) & 15, pw) * 16 + ((sx >> 6) & 15)
        vf = I.filter_index(interp & 15, ph) * 16 + ((sy >> 6) & 15)
        return (rb, rs, lastx, lasty, cx, cy, hf, vf)

    def _build_lanes(self, seq, hdr, plans, sch):
        g = plans.grid
        mi_rows, mi_cols = plans.mi_rows, plans.mi_cols
        inter = np.asarray(g("is_inter")) != 0
        by_g = np.asarray(g("by"))
        bx_g = np.asarray(g("bx"))
        blocks = np.unique((by_g.astype(np.int64) * mi_cols + bx_g)
                           [inter])
        num_planes = sch.num_planes
        sub_x, sub_y = sch.sub_x, sch.sub_y
        r0 = 5 if sch.bd == 12 else 3
        post = 14 - r0 - 7
        order_hint = hdr.get("order_hint", 0)
        order_hints = hdr.get("order_hints", [0] * 8)
        hint_bits = hdr.get("order_hint_bits", 0)
        enable_hint = hdr.get("enable_order_hint_seq", 0)

        def rel_dist(a, b):
            if not enable_hint:
                return 0
            diff = a - b
            m = 1 << (hint_bits - 1)
            return (diff & (m - 1)) - (diff & m)

        def gi(name, r, c):
            return int(g(name)[r, c])

        lanes = {}  # (T, comp) -> list of rows

        def emit(plane, px, py, pw, ph, mr, mc):
            """One prediction unit from the mi at (mr, mc)."""
            ssx = sub_x if plane else 0
            ssy = sub_y if plane else 0
            ref0 = gi("ref0", mr, mc)
            ref1 = gi("ref1", mr, mc)
            interp = gi("interp", mr, mc)
            comp = ref1 > INTRA_FRAME
            row = np.zeros(len(MC_FIELDS), np.int64)
            row[_MF["x"]], row[_MF["y"]] = px, py
            row[_MF["base"]] = sch.plane_base[plane]
            row[_MF["stride"]] = sch.alloc_dims[plane][1]
            row[_MF["w"]], row[_MF["h"]] = pw, ph
            p0 = self._list_params(plane, px, py, pw, ph,
                                   gi("mv0y", mr, mc), gi("mv0x", mr, mc),
                                   ref0, interp, ssx, ssy)
            for k, f in enumerate(("rb0", "rs0", "lx0", "ly0", "cx0",
                                   "cy0", "hf0", "vf0")):
                row[_MF[f]] = p0[k]
            if comp:
                p1 = self._list_params(plane, px, py, pw, ph,
                                       gi("mv1y", mr, mc),
                                       gi("mv1x", mr, mc),
                                       ref1, interp, ssx, ssy)
                for k, f in enumerate(("rb1", "rs1", "lx1", "ly1", "cx1",
                                       "cy1", "hf1", "vf1")):
                    row[_MF[f]] = p1[k]
                if gi("compound_type", mr, mc) == 1:  # distance-weighted
                    d0 = min(I.MAX_FRAME_DISTANCE,
                             abs(rel_dist(order_hints[ref1], order_hint)))
                    d1 = min(I.MAX_FRAME_DISTANCE,
                             abs(rel_dist(order_hints[ref0], order_hint)))
                    fwd, bck = I.dist_weights(d0, d1)
                    row[_MF["w0"]], row[_MF["w1"]] = fwd, bck
                    row[_MF["bshift"]] = post + 4
                else:                                  # average
                    row[_MF["w0"]] = row[_MF["w1"]] = 1
                    row[_MF["bshift"]] = post + 1
            key = (_bucket_for(pw, ph), int(comp))
            lanes.setdefault(key, []).append(row)

        for b in blocks:
            by, bx = int(b) // mi_cols, int(b) % mi_cols
            bsize = gi("bsize", by, bx)
            bw4, bh4 = BLOCK_W4[bsize], BLOCK_H4[bsize]
            has_chroma = num_planes > 1 and \
                ((by & 1) or not (bh4 & 1) or not sub_y) and \
                ((bx & 1) or not (bw4 & 1) or not sub_x)
            n_planes = num_planes if has_chroma else 1
            for plane in range(n_planes):
                ssx = sub_x if plane else 0
                ssy = sub_y if plane else 0
                row0, col0 = by, bx
                if plane and ssy and bh4 == 1:
                    row0 = by & ~1
                if plane and ssx and bw4 == 1:
                    col0 = bx & ~1
                cells = False
                if plane and (row0 != by or col0 != bx):
                    some_intra = False
                    for mr in range(row0, by + bh4):
                        for mc in range(col0, bx + bw4):
                            if gi("ref0", mr, mc) <= INTRA_FRAME:
                                some_intra = True
                    cells = not some_intra
                px0 = (col0 * 4) >> ssx
                py0 = (row0 * 4) >> ssy
                pw = ((bx + bw4 - col0) * 4) >> ssx
                ph = ((by + bh4 - row0) * 4) >> ssy
                if cells:
                    # sub-8x8 chroma: one piece per covering mi, each
                    # from that mi's own mv/ref/filter [SPEC §7.11.1]
                    pred_w = (bw4 * 4) >> ssx
                    pred_h = (bh4 * 4) >> ssy
                    for yy in range(0, ph, pred_h):
                        for xx in range(0, pw, pred_w):
                            mr = row0 + ((yy << ssy) >> 2)
                            mc = col0 + ((xx << ssx) >> 2)
                            emit(plane, px0 + xx, py0 + yy,
                                 pred_w, pred_h, mr, mc)
                else:
                    emit(plane, px0, py0, pw, ph, by, bx)
        return {k: np.asarray(v, np.int64) for k, v in lanes.items()}
