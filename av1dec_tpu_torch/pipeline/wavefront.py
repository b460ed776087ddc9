"""Wavefront schedule of an all-intra frame. [SPEC §7.11.2, SURVEY §7.1]

Host half of the scan, copied from `av1dec_tpu.pipeline.wavefront`:
every transform block gets a wavefront level such that all of its
prediction inputs (reconstructed neighbour pixels) were written at
strictly earlier levels, and all control flow (availability, clamp
limits, edge-filter strength, upsample flags, CfL alphas, palette
contents) becomes per-block int scalars.  The device executes only
pixel gathers, integer arithmetic and scatters
(`av1dec_tpu_torch.ops.kernels.wavefront`).

Differences from the original: the palette prediction and the CfL
alpha of `FrameRecon` are plain functions here (`_palette_pred`,
`_alpha`), and the scalar schedule builder and the NumPy executor are
left out.
"""

from __future__ import annotations

import numpy as np

from av1dec_tpu_torch.ops.spec import dequant, intra, itx
from av1dec_tpu_torch.ops.tables_data import DR_INTRA_DERIVATIVE

TX_DIMS = itx.TX_DIMS
UV_CFL_PRED = 13

# mode family tags for the executor; MF_INTER = "prediction already in
# the frame buffer" (the device MC pass runs before the scan): the lane
# just gathers its own block, adds the residual, clips, writes back
MF_DC, MF_V, MF_H, MF_DIR, MF_SMOOTH, MF_SMOOTH_V, MF_SMOOTH_H, \
    MF_PAETH, MF_PAL, MF_FI, MF_INTER = range(11)

_SCALAR_FIELDS = [
    "x", "y", "plane", "base", "stride", "mode_family", "p_angle",
    "above_case", "above_lim", "left_case", "left_lim", "corner_case",
    "str_above", "str_left", "up_above", "up_left",
    "npx_above", "npx_left", "corner_filt", "dx", "dy",
    "have_above", "have_left", "res_idx", "pal_idx", "fi_mode",
    "cfl_alpha", "cfl_maxx", "cfl_maxy", "dc_case",
]


class BlockClass:
    """All blocks of one (w, h) transform shape, grouped by level."""

    def __init__(self, w, h):
        self.w = w
        self.h = h
        self._levels = []
        self._rows = []       # list of per-block scalar tuples
        self.packed = None    # {field: [N]} sorted by level
        self.level_slices = None  # level -> (start, end)

    def add(self, level, scal):
        self._levels.append(level)
        self._rows.append(tuple(scal[f] for f in _SCALAR_FIELDS))

    def finalize(self):
        lv = np.asarray(self._levels, np.int64)
        rows = np.asarray(self._rows, np.int64)
        order = np.argsort(lv, kind="stable")
        lv = lv[order]
        rows = rows[order]
        self.packed = {f: np.ascontiguousarray(rows[:, k])
                       for k, f in enumerate(_SCALAR_FIELDS)}
        self.levels_sorted = lv
        # level -> slice bounds
        self.level_slices = {}
        if len(lv):
            uniq, starts = np.unique(lv, return_index=True)
            ends = np.append(starts[1:], len(lv))
            for u, s, e in zip(uniq, starts, ends):
                self.level_slices[int(u)] = (int(s), int(e))
        self._rows = self._levels = None

    def at_level(self, lvl):
        se = self.level_slices.get(lvl)
        if se is None:
            return None
        s, e = se
        return {f: a[s:e] for f, a in self.packed.items()}


class Schedule:
    def __init__(self, seq, hdr, plans):
        self.seq = seq
        self.hdr = hdr
        self.plans = plans
        self.bd = seq["bit_depth"]
        self.sub_x = seq["subsampling_x"]
        self.sub_y = seq["subsampling_y"]
        self.num_planes = 1 if seq["mono_chrome"] else 3
        self.enable_edge_filter = bool(seq["enable_intra_edge_filter"])
        self.classes = {}  # (w, h) -> BlockClass
        self.n_levels = 0
        self.has_inter = False
        self.pal_preds = {}   # (w, h) -> [np (h, w)] palette predictions
        self.res_count = {}   # (w, h) -> count of residual slots
        self.res_recs = {}    # (w, h) -> list of plans.tx record indices
        # frame layout: flat concatenation of the mi-padded plane allocs
        h4, w4 = plans.mi_rows * 4, plans.mi_cols * 4
        sb = 128 if seq.get("use_128x128_superblock") else 64
        ha = (h4 + sb - 1) // sb * sb
        wa = (w4 + sb - 1) // sb * sb
        self.alloc_dims = [(ha, wa)]
        self.valid_dims = [(h4, w4)]
        for _ in range(self.num_planes - 1):
            self.alloc_dims.append((ha >> self.sub_y, wa >> self.sub_x))
            self.valid_dims.append((h4 >> self.sub_y, w4 >> self.sub_x))
        self.plane_base = np.cumsum(
            [0] + [a * b for a, b in self.alloc_dims])[:3].tolist()
        self.flat_len = sum(a * b for a, b in self.alloc_dims)


def compute_residuals(sch):
    """Per-(w, h) residual tensors [N, h, w] (NumPy, batched by tx
    bucket as in FrameRecon._precompute_residuals)."""
    plans, hdr, bd = sch.plans, sch.hdr, sch.bd
    q = hdr["quant"]
    use_qm = bool(q.get("using_qmatrix"))
    qm_by_plane = (q.get("qm_y", 15), q.get("qm_u", 15),
                   q.get("qm_v", 15))
    out = {key: np.zeros((n, key[1], key[0]), np.int32)
           for key, n in sch.res_count.items()}
    # bucket rows of each (w,h) tensor by (tsz, tt)
    buckets = {}
    for key, recs in sch.res_recs.items():
        for slot, i in enumerate(recs):
            rec = plans.tx[i]
            buckets.setdefault((int(rec[3]), int(rec[4])), []).append(
                (key, slot, i))
    g = plans.grid
    qindex_g = g("qindex")
    lossless_g = g("lossless")
    mi_cols = plans.mi_cols
    for (tsz, tt), items in buckets.items():
        w, h = (4, 4) if tsz == 19 else TX_DIMS[tsz]
        aw, ah = (4, 4) if tsz == 19 else (min(w, 32), min(h, 32))
        n = aw * ah
        B = len(items)
        qm_ok = use_qm and tt < 9  # qm only for 2-D transforms
        idxa = np.fromiter((i for _, _, i in items), np.int64, B)
        recs = np.asarray(plans.tx, np.int64)[idxa]
        offs = recs[:, 6]
        levels = np.asarray(plans.coeffs, np.int64)[
            offs[:, None] + np.arange(n)]
        mi_r, mi_c = recs[:, 7] // mi_cols, recs[:, 7] % mi_cols
        qidx = qindex_g[mi_r, mi_c].astype(np.int64)
        lossless = lossless_g[mi_r, mi_c].astype(bool)
        plane = recs[:, 0]
        dcd = np.choose(np.minimum(plane, 2),
                        [q["delta_q_y_dc"], q["delta_q_u_dc"],
                         q["delta_q_v_dc"]])
        acd = np.choose(np.minimum(plane, 2),
                        [0, q["delta_q_u_ac"], q["delta_q_v_ac"]])
        qml = np.where(qm_ok & ~lossless,
                       np.asarray(qm_by_plane)[np.minimum(plane, 2)], 15)
        qmc = (plane >= 1) & (qml < 15)
        if tsz == 19 or lossless.any():
            from av1dec_tpu_torch.ops.qm_data import qm_row
            for b, (key, slot, i) in enumerate(items):
                dq = dequant.dequant_block(
                    levels[b], tsz, int(qidx[b]), bd,
                    int(dcd[b]), int(acd[b]), bool(lossless[b]),
                    qm=qm_row(int(qml[b]), bool(qmc[b]), w, h))
                out[key][slot] = itx.inverse_transform(dq, tsz, tt, bd)
            continue
        dq = dequant.dequant_batch(levels, tsz, qidx, bd, dcd, acd,
                                   qm_levels=qml, qm_chroma=qmc)
        res = itx.inverse_transform_lanes(dq, tsz, tt, bd)
        for b, (key, slot, i) in enumerate(items):
            out[key][slot] = res[b]
    return out



def _alpha(joint_sign, alpha_idx, plane):
    # cfl_idx_to_alpha [SPEC §7.11.5]
    sign = (joint_sign + 1) // 3 if plane == 1 else (joint_sign + 1) % 3
    if sign == 0:
        return 0
    abs_alpha = (alpha_idx >> 4) & 15 if plane == 1 else alpha_idx & 15
    a = abs_alpha + 1
    return -a if sign == 1 else a


_BLOCK_W4 = [1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32,
             1, 4, 2, 8, 4, 16]
_BLOCK_H4 = [1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32,
             4, 1, 8, 2, 16, 4]


def _palette_pred(plans, sub_x, sub_y, plane, mi_r, mi_c, x, y, w, h):
    """Palette prediction of one transform block [SPEC §7.11.4]
    (`FrameRecon._palette_pred`; sub_x/sub_y are the sequence's)."""
    bsize = plans.grid("bsize")
    # find the palette record for this block
    for pi in range(len(plans.palettes) - 1, -1, -1):
        rec = plans.palettes[pi]
        if rec[0] <= mi_r and rec[1] <= mi_c:
            bs_r, bs_c = int(rec[0]), int(rec[1])
            if int(bsize[bs_r, bs_c]) >= 0:
                break
    rec = plans.palettes[pi]
    colors = rec[4:].reshape(3, 8)
    pair = 0 if plane == 0 else 1
    off = int(plans.color_map_off[pi, pair])
    sub_x = sub_x if plane else 0
    sub_y = sub_y if plane else 0
    # map dims: full block (padded) dims as emitted
    bsz = int(bsize[bs_r, bs_c])
    bw = (_BLOCK_W4[bsz] * 4) >> sub_x
    bh = (_BLOCK_H4[bsz] * 4) >> sub_y
    ox = x - ((bs_c * 4) >> sub_x)
    oy = y - ((bs_r * 4) >> sub_y)
    # a chroma map under 4 samples wide (high) — a 4x16 or 16x4 block's
    # in 4:2:0 — covers the block pair's 4 chroma samples from the pair's
    # start, 2 before this block's own [SPEC §5.11.49 palette_tokens]
    if bw < 4:
        bw, ox = bw + 2, ox + 2
    if bh < 4:
        bh, oy = bh + 2, oy + 2
    cmap = plans.color_map[off: off + bw * bh].reshape(bh, bw)
    idxs = cmap[oy: oy + h, ox: ox + w]
    comp = 0 if plane == 0 else plane  # 1 -> U colors, 2 -> V colors
    return colors[comp][idxs].astype(np.int64)


# ---------------------------------------------------------------------------
# Vectorized schedule builder (numpy field assembly + native level DP)
# ---------------------------------------------------------------------------

_W_LUT = np.array([TX_DIMS[t][0] for t in range(19)] + [4], np.int32)
_H_LUT = np.array([TX_DIMS[t][1] for t in range(19)] + [4], np.int32)
_M2A = np.array(intra.MODE_TO_ANGLE + [0], np.int32)

# strength/upsample LUTs over (filter_type, blk_wh, |delta|)
_STR_LUT = None
_UP_LUT = None


def _edge_luts():
    global _STR_LUT, _UP_LUT
    if _STR_LUT is None:
        s = np.zeros((2, 129, 181), np.int8)
        u = np.zeros((2, 129, 181), np.int8)
        for ft in range(2):
            for wh in range(129):
                for d in range(181):
                    s[ft, wh, d] = intra.intra_edge_filter_strength(
                        wh // 2, wh - wh // 2, ft, d)
                    u[ft, wh, d] = intra.use_intra_edge_upsample(
                        wh // 2, wh - wh // 2, ft, d)
        _STR_LUT, _UP_LUT = s, u
    return _STR_LUT, _UP_LUT


def build_schedule_fast(seq, hdr, plans, filter_type_fn=None,
                        allow_inter=False):
    """Vectorized build_schedule: same Schedule, numpy field assembly
    over the whole tx-record array + native ASAP level DP
    (bindings.wavefront_levels).  `filter_type_fn` is unused (the
    neighbor-smoothness filter type is computed from the mi grids
    directly); kept for signature compatibility.

    With `allow_inter`, mixed frames build too: inter tx records become
    MF_INTER residual-add lanes at level 1 (their predictions are
    written by the MC pass before the scan; records with eob == 0 need
    no lane at all), and intra blocks schedule after them."""
    if plans is None or plans.grid("intrabc").any():
        return None
    if plans.grid("is_inter").any() and not allow_inter:
        return None
    from av1dec_tpu_torch.bindings import wavefront_levels
    sch = Schedule(seq, hdr, plans)
    mi_cols, mi_rows = plans.mi_cols, plans.mi_rows
    tx = np.asarray(plans.tx, np.int64)
    if len(tx) == 0:
        return None
    inter_g = plans.grid("is_inter")
    mi_all = tx[:, 7]
    rec_inter_all = inter_g[(mi_all // mi_cols).astype(np.int64),
                            (mi_all % mi_cols).astype(np.int64)] != 0
    sch.has_inter = bool(rec_inter_all.any())
    # inter records without residual need no lane (MC already wrote
    # their final pixels); res_recs must keep ORIGINAL plans.tx indices
    keep = ~rec_inter_all | (tx[:, 5] > 0)
    orig_idx = np.nonzero(keep)[0]
    tx = tx[keep]
    N = len(tx)
    if N == 0:
        # every block is a skipped inter block: nothing to scan
        sch.n_levels = 0
        return sch
    plane = tx[:, 0].astype(np.int32)
    x4, y4 = tx[:, 1].astype(np.int32), tx[:, 2].astype(np.int32)
    tsz, tt, eob = tx[:, 3], tx[:, 4], tx[:, 5]
    mi, avail = tx[:, 7], tx[:, 8]
    w = _W_LUT[tsz]
    h = _H_LUT[tsz]
    mi_r, mi_c = (mi // mi_cols).astype(np.int64), \
        (mi % mi_cols).astype(np.int64)
    rec_inter = inter_g[mi_r, mi_c] != 0
    intra_rec = ~rec_inter
    x, y = x4 * 4, y4 * 4
    have_left = ((avail & 1) != 0) & intra_rec
    have_above = ((avail & 2) != 0) & intra_rec
    have_ar = ((avail & 4) != 0) & intra_rec
    have_bl = ((avail & 8) != 0) & intra_rec

    F = {f: np.zeros(N, np.int64) for f in _SCALAR_FIELDS}
    F["x"], F["y"], F["plane"] = x, y, plane
    pb = np.asarray(sch.plane_base + [0] * (3 - len(sch.plane_base)))
    st = np.asarray([a[1] for a in sch.alloc_dims] + [0] * 3)[:3]
    vw = np.asarray([a[1] for a in sch.valid_dims] + [0] * 3)[:3]
    vh = np.asarray([a[0] for a in sch.valid_dims] + [0] * 3)[:3]
    F["base"] = pb[plane]
    F["stride"] = st[plane]
    max_x, max_y = vw[plane] - 1, vh[plane] - 1
    F["have_above"] = have_above.astype(np.int64)
    F["have_left"] = have_left.astype(np.int64)
    F["res_idx"] = np.full(N, -1)
    F["pal_idx"] = np.full(N, -1)
    F["fi_mode"] = np.full(N, -1)

    F["above_case"] = np.where(have_above, 0, np.where(have_left, 1, 2))
    F["above_lim"] = np.where(
        have_above,
        np.minimum(max_x, x + np.where(have_ar, 2 * w, w) - 1), 0)
    F["left_case"] = np.where(have_left, 0, np.where(have_above, 1, 2))
    F["left_lim"] = np.where(
        have_left,
        np.minimum(max_y, y + np.where(have_bl, 2 * h, h) - 1), 0)
    F["corner_case"] = np.where(
        have_above & have_left, 0,
        np.where(have_above, 1, np.where(have_left, 2, 3)))

    # grids gathered at the block's mi cell
    g = plans.grid
    mode = np.where(plane == 0, g("mode")[mi_r, mi_c],
                    g("uv_mode")[mi_r, mi_c]).astype(np.int64)
    angle = np.where(plane == 0, g("angle_y")[mi_r, mi_c],
                     g("angle_uv")[mi_r, mi_c]).astype(np.int64)
    fi_mode = np.where(plane == 0, g("filter_intra")[mi_r, mi_c],
                       -1).astype(np.int64)
    use_pal = (np.where(plane == 0, g("palette_y")[mi_r, mi_c],
                        g("palette_uv")[mi_r, mi_c]) > 0) & intra_rec
    is_cfl = (plane > 0) & (mode == UV_CFL_PRED) & intra_rec

    mf_pal = use_pal
    mf_fi = ~mf_pal & (fi_mode >= 0) & intra_rec
    mf_dc = ~mf_pal & ~mf_fi & (is_cfl | (mode == intra.DC_PRED)) & \
        intra_rec
    mf_smooth = ~mf_pal & ~mf_fi & ~mf_dc & \
        (mode >= intra.SMOOTH_PRED) & (mode <= intra.SMOOTH_H_PRED) & \
        intra_rec
    mf_paeth = ~mf_pal & ~mf_fi & ~mf_dc & ~mf_smooth & \
        (mode == intra.PAETH_PRED) & intra_rec
    mf_dirish = ~(mf_pal | mf_fi | mf_dc | mf_smooth | mf_paeth) & \
        intra_rec

    p_angle = np.where(mf_dirish,
                       _M2A[np.minimum(mode, 12)] +
                       angle * intra.ANGLE_STEP, 0)
    mf_v = mf_dirish & (p_angle == 90)
    mf_h = mf_dirish & (p_angle == 180)
    mf_dir = mf_dirish & ~mf_v & ~mf_h

    fam = np.zeros(N, np.int64)
    fam[rec_inter] = MF_INTER
    fam[mf_pal] = MF_PAL
    fam[mf_fi] = MF_FI
    fam[mf_dc] = MF_DC
    fam[mf_smooth] = np.where(
        mode[mf_smooth] == intra.SMOOTH_PRED, MF_SMOOTH,
        np.where(mode[mf_smooth] == intra.SMOOTH_V_PRED, MF_SMOOTH_V,
                 MF_SMOOTH_H))
    fam[mf_paeth] = MF_PAETH
    fam[mf_v] = MF_V
    fam[mf_h] = MF_H
    fam[mf_dir] = MF_DIR
    F["mode_family"] = fam
    F["p_angle"] = p_angle
    F["fi_mode"] = np.where(mf_fi, fi_mode, -1)

    # DC case + CfL
    F["dc_case"] = np.where(
        ~mf_dc, 0,
        np.where(have_above & have_left, 0,
                 np.where(have_above, 1, np.where(have_left, 2, 3))))
    if is_cfl.any():
        signs = g("cfl_signs")[mi_r, mi_c].astype(np.int64)
        aidx = g("cfl_alpha_idx")[mi_r, mi_c].astype(np.int64)
        sgn = np.where(plane == 1, (signs + 1) // 3, (signs + 1) % 3)
        mag = np.where(plane == 1, (aidx >> 4) & 15, aidx & 15) + 1
        alpha = np.where(sgn == 0, 0, np.where(sgn == 1, -mag, mag))
        F["cfl_alpha"] = np.where(is_cfl & mf_dc, alpha, 0)
        F["cfl_maxx"] = np.where(
            is_cfl & mf_dc,
            np.minimum((x + w) << sch.sub_x, mi_cols * 4) -
            (1 << sch.sub_x), 0)
        F["cfl_maxy"] = np.where(
            is_cfl & mf_dc,
            np.minimum((y + h) << sch.sub_y, mi_rows * 4) -
            (1 << sch.sub_y), 0)

    # directional: edge filter params + gradients
    if mf_dir.any():
        size = w + h
        if sch.enable_edge_filter:
            F["corner_filt"] = (mf_dir & (p_angle > 90) &
                                (p_angle < 180) & (size >= 24)) \
                .astype(np.int64)
            # neighbor-smoothness filter type [SPEC §7.11.2.8]
            sm_y = np.isin(g("mode"), (9, 10, 11)) & \
                (g("is_inter") == 0)
            sm_uv = np.isin(g("uv_mode"), (9, 10, 11)) & \
                (g("is_inter") == 0)

            def smooth_at(r, c, chroma):
                ok = (r >= 0) & (c >= 0) & (r < mi_rows) & (c < mi_cols)
                rr = np.clip(r, 0, mi_rows - 1)
                cc = np.clip(c, 0, mi_cols - 1)
                v = np.where(chroma, sm_uv[rr, cc], sm_y[rr, cc])
                return np.where(ok, v, False)

            chroma = plane > 0
            a_r = np.where(chroma, (mi_r & ~sch.sub_y) - 1, mi_r - 1)
            a_c = np.where(chroma, mi_c | sch.sub_x, mi_c)
            l_r = np.where(chroma, mi_r | sch.sub_y, mi_r)
            l_c = np.where(chroma, (mi_c & ~sch.sub_x) - 1, mi_c - 1)
            ftype = ((have_above & smooth_at(a_r, a_c, chroma)) |
                     (have_left & smooth_at(l_r, l_c, chroma))) \
                .astype(np.int64)
            sLUT, uLUT = _edge_luts()
            d_a = np.abs(p_angle - 90)
            d_l = np.abs(p_angle - 180)
            whc = np.minimum(size, 128)
            F["str_above"] = np.where(
                mf_dir & have_above, sLUT[ftype, whc, d_a], 0)
            F["npx_above"] = np.where(
                mf_dir & have_above,
                np.minimum(w, max_x - x + 1) +
                np.where(p_angle < 90, h, 0) + 1, 0)
            F["str_left"] = np.where(
                mf_dir & have_left, sLUT[ftype, whc, d_l], 0)
            F["npx_left"] = np.where(
                mf_dir & have_left,
                np.minimum(h, max_y - y + 1) +
                np.where(p_angle > 180, w, 0) + 1, 0)
            F["up_above"] = np.where(mf_dir, uLUT[ftype, whc, d_a], 0)
            F["up_left"] = np.where(mf_dir, uLUT[ftype, whc, d_l], 0)
        dr = np.asarray(DR_INTRA_DERIVATIVE, np.int64)
        nd = len(dr) - 1
        pa = np.clip(p_angle, 0, 270)

        def drl(idx):
            return dr[np.clip(idx, 0, nd)]

        F["dx"] = np.where(
            mf_dir & (p_angle < 90), drl(pa),
            np.where(mf_dir & (p_angle < 180), drl(np.abs(180 - pa)), 0))
        F["dy"] = np.where(
            mf_dir & (p_angle > 90) & (p_angle < 180),
            drl(np.abs(pa - 90)),
            np.where(mf_dir & (p_angle > 180), drl(np.abs(270 - pa)), 0))

    # levels via the native DP (inter lanes: no deps, level 1)
    ext_above = mf_dir & (p_angle < 90)
    ext_left = mf_dir & (p_angle > 180)
    levels, n_levels = wavefront_levels(
        plane, x4, y4, w // 4, h // 4, ext_above, ext_left, is_cfl,
        mi_rows, mi_cols, sch.sub_x, sch.sub_y, sch.num_planes,
        skip_dep=rec_inter)
    sch.n_levels = n_levels
    levels = levels.astype(np.int64)

    # per-class slot assignment (tx order within class, like the scalar
    # builder) + class assembly
    class_key = (w.astype(np.int64) << 8) | h.astype(np.int64)
    for key_packed in np.unique(class_key):
        kw, kh = int(key_packed) >> 8, int(key_packed) & 0xFF
        key = (kw, kh)
        sel = np.where(class_key == key_packed)[0]
        # residual slots (res_recs carry ORIGINAL plans.tx indices)
        res_sel = sel[eob[sel] > 0]
        F["res_idx"][res_sel] = np.arange(len(res_sel))
        if len(res_sel):
            sch.res_count[key] = len(res_sel)
            sch.res_recs[key] = orig_idx[res_sel].tolist()
        # palette predictions (rare: scalar loop)
        pal_sel = sel[use_pal[sel]]
        if len(pal_sel):
            F["pal_idx"][pal_sel] = np.arange(len(pal_sel))
            preds = []
            for i in pal_sel:
                preds.append(_palette_pred(
                    plans, sch.sub_x, sch.sub_y,
                    int(plane[i]), int(mi_r[i]), int(mi_c[i]),
                    int(x[i]), int(y[i]), kw, kh).astype(np.int32))
            sch.pal_preds[key] = preds
        # packed class, sorted by level
        lv = levels[sel]
        order = np.argsort(lv, kind="stable")
        sidx = sel[order]
        bc = BlockClass(kw, kh)
        bc.packed = {f: np.ascontiguousarray(F[f][sidx])
                     for f in _SCALAR_FIELDS}
        bc.levels_sorted = lv[order]
        bc.level_slices = {}
        if len(sidx):
            uniq, starts = np.unique(bc.levels_sorted, return_index=True)
            ends = np.append(starts[1:], len(sidx))
            for u_, s_, e_ in zip(uniq, starts, ends):
                bc.level_slices[int(u_)] = (int(s_), int(e_))
        sch.classes[key] = bc
    return sch


build_schedule = build_schedule_fast
