"""Block-level inter prediction driver for FrameRecon. [SPEC §7.11.1/§7.11.3]

Covers: translational MC (all filter banks, ref scaling), intra-bc,
sub-8x8 chroma prediction with per-mi MVs, compound blends (average,
distance-weighted, wedge, diff-weighted), inter-intra, OBMC, and warped
motion (local + global).
"""
from __future__ import annotations

import numpy as np

from av1dec_tpu_torch.ops.spec import inter as I

BLOCK_W4 = [1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32,
            1, 4, 2, 8, 4, 16]
BLOCK_H4 = [1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32,
            4, 1, 8, 2, 16, 4]

INTRA_FRAME = 0
NONE_FRAME = -1
GLOBALMV = 15
GLOBAL_GLOBALMV = 23

# max OBMC neighbors by log2(mi dim) [libaom max_neighbor_obmc]
MAX_NEIGHBOR_OBMC = [0, 1, 2, 3, 4, 4, 4]


class InterPredictor:
    """Performs whole-block inter prediction into the frame buffers."""

    def __init__(self, recon):
        self.r = recon  # FrameRecon
        hdr = recon.hdr
        self.refs = recon.refs or {}
        self.order_hint = hdr.get("order_hint", 0)
        self.order_hints = hdr.get("order_hints", [0] * 8)
        self.hint_bits = hdr.get("order_hint_bits", 0)
        self.enable_hint = hdr.get("enable_order_hint_seq", 0)
        self.frame_w = hdr["frame_width"]
        self.frame_h = hdr["frame_height"]
        g = hdr.get("gm") or {}
        self.gm_type = g.get("type", [0] * 8)
        self.gm_params = np.asarray(
            g.get("params", [0] * 48), np.int64).reshape(8, 6)
        # tile boundaries for availability
        t = hdr["tiles"]
        self.row_starts = t["mi_row_starts"]
        self.col_starts = t["mi_col_starts"]
        self._gm_shear = {}

    # -- helpers -----------------------------------------------------------
    def rel_dist(self, a, b):
        if not self.enable_hint:
            return 0
        diff = a - b
        m = 1 << (self.hint_bits - 1)
        return (diff & (m - 1)) - (diff & m)

    def _tile_row_start(self, mi_r):
        s = 0
        for v in self.row_starts:
            if v <= mi_r:
                s = v
        return s

    def _tile_col_start(self, mi_c):
        s = 0
        for v in self.col_starts:
            if v <= mi_c:
                s = v
        return s

    def _ref_planes(self, ref):
        """(planes, luma_w, luma_h) for spec ref enum 1..7."""
        ent = self.refs.get(ref)
        if ent is None:
            raise ValueError(f"reference frame {ref} missing from DPB")
        return ent["planes"], ent["width"], ent["height"]

    def _gm_shear_params(self, ref):
        if ref not in self._gm_shear:
            self._gm_shear[ref] = I.setup_shear(self.gm_params[ref])
        return self._gm_shear[ref]

    # -- single-list prediction -------------------------------------------
    def _pred_one(self, plane, px, py, pw, ph, mv_row, mv_col, ref,
                  interp_packed, is_compound, use_warp, warp_params,
                  warp_shear, intrabc):
        r = self.r
        ssx = r.sub_x if plane else 0
        ssy = r.sub_y if plane else 0
        bd = r.bd
        if intrabc:
            ref_planes = r._alloc_view()
            ref_w, ref_h = self.frame_w, self.frame_h
        else:
            ref_planes, ref_w, ref_h = self._ref_planes(ref)
        rp = ref_planes[plane]
        if use_warp:
            valid, alpha, beta, gamma, delta = warp_shear
            return I.warp_block(rp, warp_params, px, py, pw, ph, bd,
                                is_compound, ref_w, ref_h, ssx, ssy,
                                alpha, beta, gamma, delta)
        fx = I.filter_index(interp_packed >> 4 & 15, pw)
        fy = I.filter_index(interp_packed & 15, ph)
        return I.block_inter_pred(rp, px, py, pw, ph, mv_row, mv_col,
                                  fx, fy, bd, is_compound, ref_w, ref_h,
                                  self.frame_w, self.frame_h, ssx, ssy)

    # -- main entry --------------------------------------------------------
    def predict_block(self, by, bx):
        r = self.r
        g = r.g
        bsize = g("bsize", by, bx)
        bw4, bh4 = BLOCK_W4[bsize], BLOCK_H4[bsize]
        intrabc = bool(g("intrabc", by, bx))
        ref0 = g("ref0", by, bx)
        ref1 = g("ref1", by, bx)
        mv = [(g("mv0y", by, bx), g("mv0x", by, bx)),
              (g("mv1y", by, bx), g("mv1x", by, bx))]
        interp = g("interp", by, bx)
        motion_mode = g("motion_mode", by, bx)
        comp_type = g("compound_type", by, bx)
        wedge = g("wedge", by, bx)
        interintra = g("interintra", by, bx)
        ii_wedge = g("ii_wedge", by, bx)
        is_compound = ref1 > INTRA_FRAME
        mode = g("mode", by, bx)

        has_chroma = r.num_planes > 1 and \
            ((by & 1) or not (bh4 & 1) or not r.sub_y) and \
            ((bx & 1) or not (bw4 & 1) or not r.sub_x)

        # warp selection [SPEC §7.11.3.1]
        warp_params = None
        warp_shear = None
        use_warp = False
        if not intrabc and min(4 * bw4, 4 * bh4) >= 8:
            if motion_mode == 2:  # WARPED_CAUSAL
                wp = r.warp_for_block(by, bx)
                if wp is not None and not wp["invalid"]:
                    shear = I.setup_shear(wp["params"])
                    if shear[0]:
                        warp_params = np.asarray(wp["params"], np.int64)
                        warp_shear = shear
                        use_warp = True
                if not use_warp and mode in (GLOBALMV, GLOBAL_GLOBALMV) \
                        and self.gm_type[ref0] > 1 and not self._scaled(ref0):
                    # local warp invalid -> global warp fallback
                    shear = self._gm_shear_params(ref0)
                    if shear[0]:
                        warp_params = self.gm_params[ref0]
                        warp_shear = shear
                        use_warp = True
            elif mode in (GLOBALMV, GLOBAL_GLOBALMV) and \
                    self.gm_type[ref0] > 1 and not self._scaled(ref0):
                shear = self._gm_shear_params(ref0)
                if shear[0]:
                    warp_params = self.gm_params[ref0]
                    warp_shear = shear
                    use_warp = True

        n_planes = r.num_planes if has_chroma else 1
        diff_mask = None
        for plane in range(n_planes):
            ssx = r.sub_x if plane else 0
            ssy = r.sub_y if plane else 0
            # prediction region + per-mi cells (sub-8x8 chroma) [SPEC §7.11.1]
            row0, col0 = by, bx
            if plane and ssy and bh4 == 1:
                row0 = by & ~1
            if plane and ssx and bw4 == 1:
                col0 = bx & ~1
            cells = None
            if plane and (row0 != by or col0 != bx):
                some_intra = False
                for mr in range(row0, by + bh4):
                    for mc in range(col0, bx + bw4):
                        if g("ref0", mr, mc) <= INTRA_FRAME and \
                                not g("intrabc", mr, mc):
                            some_intra = True
                if not some_intra:
                    cells = [(mr, mc) for mr in range(row0, by + bh4)
                             for mc in range(col0, bx + bw4)]
            px0 = (col0 * 4) >> ssx
            py0 = (row0 * 4) >> ssy
            pw = ((bx + bw4 - col0) * 4) >> ssx
            ph = ((by + bh4 - row0) * 4) >> ssy
            frame = r._alloc[plane]

            if cells is not None:
                # sub-8x8 chroma: predict in predW x predH pieces (the
                # block's plane dims), each from the covering mi's own
                # mv/ref/filter [SPEC §7.11.1 predict_inter loop] -- piece
                # dims (not 2x2 cells) drive the 4-tap/8-tap filter choice
                pred_w = (bw4 * 4) >> ssx
                pred_h = (bh4 * 4) >> ssy
                for yy in range(0, ph, pred_h):
                    for xx in range(0, pw, pred_w):
                        mr = row0 + ((yy << ssy) >> 2)
                        mc = col0 + ((xx << ssx) >> 2)
                        cmv = (g("mv0y", mr, mc), g("mv0x", mr, mc))
                        cref = g("ref0", mr, mc)
                        cref1 = g("ref1", mr, mc)
                        cinterp = g("interp", mr, mc)
                        cbc = bool(g("intrabc", mr, mc))
                        cx, cy = px0 + xx, py0 + yy
                        if cref1 > INTRA_FRAME:
                            q0 = self._pred_one(plane, cx, cy, pred_w,
                                                pred_h,
                                                cmv[0], cmv[1], cref,
                                                cinterp, True, False,
                                                None, None, False)
                            q1 = self._pred_one(plane, cx, cy, pred_w,
                                                pred_h,
                                                g("mv1y", mr, mc),
                                                g("mv1x", mr, mc), cref1,
                                                cinterp, True, False,
                                                None, None, False)
                            pred = self._compound_blend(
                                q0, q1, g("compound_type", mr, mc), 0,
                                cref, cref1, bw4, bh4, ssx, ssy)
                        else:
                            pred = self._pred_one(plane, cx, cy, pred_w,
                                                  pred_h, cmv[0], cmv[1],
                                                  cref, cinterp, False,
                                                  False, None, None, cbc)
                        frame[cy: cy + pred_h, cx: cx + pred_w] = pred
                continue

            # warp applies only when the PLANE region is >= 8x8
            # [SPEC §7.11.3.1 useWarp]
            plane_warp = use_warp and pw >= 8 and ph >= 8
            if not is_compound:
                pred = self._pred_one(plane, px0, py0, pw, ph, mv[0][0],
                                      mv[0][1], ref0, interp,
                                      False, plane_warp, warp_params,
                                      warp_shear, intrabc)
                if interintra:
                    pred = self._interintra(plane, by, bx, bw4, bh4, px0,
                                            py0, pw, ph, pred, interintra,
                                            ii_wedge, ssx, ssy)
                frame[py0: py0 + ph, px0: px0 + pw] = pred
            else:
                p0 = self._pred_one(plane, px0, py0, pw, ph, mv[0][0],
                                    mv[0][1], ref0, interp, True,
                                    plane_warp and mode == GLOBAL_GLOBALMV
                                    and motion_mode != 2, warp_params,
                                    warp_shear, False)
                # second list: global warp applies per-ref
                use_warp1 = False
                wp1 = None
                sh1 = None
                if min(4 * bw4, 4 * bh4) >= 8 and pw >= 8 and ph >= 8 and \
                        mode == GLOBAL_GLOBALMV and \
                        self.gm_type[ref1] > 1 and not self._scaled(ref1):
                    sh1 = self._gm_shear_params(ref1)
                    if sh1[0]:
                        wp1 = self.gm_params[ref1]
                        use_warp1 = True
                p1 = self._pred_one(plane, px0, py0, pw, ph, mv[1][0],
                                    mv[1][1], ref1, interp, True,
                                    use_warp1, wp1, sh1, False)
                if comp_type == 3 and plane == 0:
                    # the difference-weighted mask comes from the luma
                    # intermediates, once per block, and chroma takes it
                    # subsampled as it takes a wedge mask [SPEC §7.11.3.12]
                    diff_mask = I.diffwtd_mask(p0, p1, wedge & 1, r.bd)
                out = self._compound_blend(p0, p1, comp_type, wedge,
                                           ref0, ref1, bw4, bh4, ssx, ssy,
                                           diff_mask)
                frame[py0: py0 + ph, px0: px0 + pw] = out

        if motion_mode == 1:  # OBMC
            self._obmc(by, bx, bw4, bh4)

    def _scaled(self, ref):
        ent = self.refs.get(ref)
        if ent is None:
            return False
        return ent["width"] != self.frame_w or ent["height"] != self.frame_h

    # -- compound blends ----------------------------------------------------
    def _compound_blend(self, p0, p1, comp_type, wedge, ref0, ref1,
                        bw4, bh4, ssx, ssy, diff_mask=None):
        bd = self.r.bd
        if comp_type == 0:  # average
            return I.avg_blend(p0, p1, bd)
        if comp_type == 1:  # distance-weighted
            d0 = min(I.MAX_FRAME_DISTANCE,
                     abs(self.rel_dist(self.order_hints[ref1],
                                       self.order_hint)))
            d1 = min(I.MAX_FRAME_DISTANCE,
                     abs(self.rel_dist(self.order_hints[ref0],
                                       self.order_hint)))
            fwd, bck = I.dist_weights(d0, d1)
            return I.dist_blend(p0, p1, fwd, bck, bd)
        if comp_type == 2:  # wedge
            mask = I.wedge_mask(bw4 * 4, bh4 * 4, wedge & 15,
                                (wedge >> 4) & 1)
            return I.mask_blend(mask, p0, p1, bd, ssx, ssy, False)
        # diffwtd: the caller's mask from the block's luma predictions
        if diff_mask is None:
            raise ValueError("difference-weighted compound needs the "
                             "block's luma mask")
        return I.mask_blend(diff_mask, p0, p1, bd, ssx, ssy, False)

    # -- inter-intra --------------------------------------------------------
    def _interintra(self, plane, by, bx, bw4, bh4, px0, py0, pw, ph,
                    inter_pred, interintra, ii_wedge, ssx, ssy):
        from av1dec_tpu_torch.ops.spec import intra as ia
        r = self.r
        mode_map = {1: 0, 2: 1, 3: 2, 4: 9}  # II -> DC/V/H/SMOOTH
        imode = mode_map[interintra]
        have_above = by > self._tile_row_start(by)
        have_left = bx > self._tile_col_start(bx)
        frame = r._alloc[plane]
        plane_h = (r.mi_rows * 4) >> ssy
        plane_w = (r.mi_cols * 4) >> ssx
        ipred = ia.predict_intra(frame, (plane_h, plane_w), px0, py0, pw,
                                 ph, imode, 0, have_left, have_above,
                                 False, False, r.bd, 0, False, -1)
        if ii_wedge >> 4:  # the luma block's wedge, subsampled for chroma
            mask = I.wedge_mask(bw4 * 4, bh4 * 4, ii_wedge & 15, 0)
            return I.mask_blend(mask, ipred, inter_pred, r.bd, ssx, ssy,
                                True)
        # the smooth masks are built at the plane block's size and not
        # subsampled [SPEC §7.11.3.13-14]
        mask = I.interintra_mask(interintra - 1, pw, ph)
        return I.mask_blend(mask, ipred, inter_pred, r.bd, 0, 0, True)

    # -- OBMC ---------------------------------------------------------------
    def _obmc(self, by, bx, bw4, bh4):
        r = self.r
        g = r.g
        w, h = bw4 * 4, bh4 * 4
        have_above = by > self._tile_row_start(by)
        have_left = bx > self._tile_col_start(bx)
        if have_above:
            nb_max = MAX_NEIGHBOR_OBMC[min(6, bw4.bit_length() - 1)]
            count = 0
            col = bx
            end_col = min(bx + bw4, r.mi_cols)
            while col < end_col and count < nb_max:
                step = min(BLOCK_W4[g("bsize", by - 1, col)], 16)
                ccol = col
                if step == 1:
                    ccol = (col & ~1) + 1
                    step = 2
                if g("ref0", by - 1, ccol) > INTRA_FRAME:
                    count += 1
                    self._obmc_one(by, bx, by - 1, ccol, col - bx,
                                   min(w, step * 4), h, True)
                col += step
        if have_left:
            nb_max = MAX_NEIGHBOR_OBMC[min(6, bh4.bit_length() - 1)]
            count = 0
            row = by
            end_row = min(by + bh4, r.mi_rows)
            while row < end_row and count < nb_max:
                step = min(BLOCK_H4[g("bsize", row, bx - 1)], 16)
                crow = row
                if step == 1:
                    crow = (row & ~1) + 1
                    step = 2
                if g("ref0", crow, bx - 1) > INTRA_FRAME:
                    count += 1
                    self._obmc_one(by, bx, crow, bx - 1, row - by,
                                   w, min(h, step * 4), False)
                row += step

    def _obmc_one(self, by, bx, nr, nc, rel4, cover_w, cover_h, above):
        """Blend one neighbor's prediction over the overlap region."""
        r = self.r
        g = r.g
        mv_row, mv_col = g("mv0y", nr, nc), g("mv0x", nr, nc)
        ref = g("ref0", nr, nc)
        interp = g("interp", nr, nc)
        w, h = cover_w, cover_h
        blk_w4 = int(BLOCK_W4[g("bsize", by, bx)])
        blk_h4 = int(BLOCK_H4[g("bsize", by, bx)])
        for plane in range(r.num_planes):
            ssx = r.sub_x if plane else 0
            ssy = r.sub_y if plane else 0
            if plane:
                # skip small chroma plane blocks in the above pass
                # [libaom av1_skip_u4x4_pred_in_obmc]
                pbw = (blk_w4 * 4) >> ssx
                pbh = (blk_h4 * 4) >> ssy
                if above and (pbw, pbh) in ((4, 4), (4, 8), (8, 4)):
                    continue
            if above:
                overlap = (min(h, 64) >> 1) >> ssy
                px = ((bx * 4) + rel4 * 4) >> ssx
                py = (by * 4) >> ssy
                pw = w >> ssx
                phh = overlap
            else:
                overlap = (min(w, 64) >> 1) >> ssx
                px = (bx * 4) >> ssx
                py = ((by * 4) + rel4 * 4) >> ssy
                pw = overlap
                phh = h >> ssy
            if pw < 1 or phh < 1 or overlap < 1:
                continue
            # skip tiny chroma regions that cannot carry a mask
            if overlap not in I._OBMC_MASKS:
                continue
            pred = self._pred_one(plane, px, py, pw, phh, mv_row, mv_col,
                                  ref, interp, False, False, None, None,
                                  False)
            frame = r._alloc[plane]
            region = frame[py: py + phh, px: px + pw]
            if above:
                blended = I.obmc_blend_above(region.copy(), pred, overlap)
            else:
                blended = I.obmc_blend_left(region.copy(), pred, overlap)
            frame[py: py + phh, px: px + pw] = blended
