"""Inter prediction — numpy spec model. [SPEC §7.11.3]

Implements motion-vector scaling (§7.11.3.3), block inter prediction with
8/6/4-tap subpel filters (§7.11.3.4), warped motion (§7.11.3.5), compound
blends: average, distance-weighted (§7.11.3.15), wedge / difference-
weighted / inter-intra masks (§7.11.3.11-14), and OBMC (§7.11.3.9-10).

All arithmetic is integer (int32/int64 numpy); compound predictions are
kept at the spec's intermediate precision until the final blend.
"""
from __future__ import annotations

import numpy as np

from av1dec_tpu_torch.ops import inter_tables as T

REF_SCALE_SHIFT = 14
SUBPEL_BITS = 4
SCALE_SUBPEL_BITS = 10
MAX_FRAME_DISTANCE = 31

# filter bank indices into T.SUBPEL_FILTERS
F_REGULAR8, F_SMOOTH8, F_SHARP8, F_BILINEAR, F_REGULAR4, F_SMOOTH4 = range(6)


def inter_rounds(bd: int, is_compound: bool):
    """(InterRound0, InterRound1, InterPostRound) [SPEC §7.11.3.2]"""
    r0 = 5 if bd == 12 else 3
    r1 = 7 if is_compound else (9 if bd == 12 else 11)
    post = 2 * 7 - (r0 + r1)  # FILTER_BITS = 7
    return r0, r1, post


def filter_index(interp_filter: int, dim: int) -> int:
    """Bank selection: blocks with dim <= 4 use the short variants
    [SPEC §7.11.3.4]."""
    if dim <= 4:
        if interp_filter in (0, 2):  # REGULAR / SHARP
            return F_REGULAR4
        if interp_filter == 1:
            return F_SMOOTH4
        return F_BILINEAR
    return interp_filter  # 0..3 map directly


def scale_values(ref_w: int, ref_h: int, frame_w: int, frame_h: int):
    x_scale = ((ref_w << REF_SCALE_SHIFT) + (frame_w // 2)) // frame_w
    y_scale = ((ref_h << REF_SCALE_SHIFT) + (frame_h // 2)) // frame_h
    return x_scale, y_scale


def _round2s(x, n):
    # Round2 with arithmetic shift (floor); fine for non-negative values
    # and for the spec's plain Round2 on signed quantities.
    return (x + (1 << (n - 1))) >> n


def _round2_signed(x, n):
    """Round2Signed [SPEC §4.7]: round half away from zero.  Differs
    from _round2s exactly at negative half-boundaries (e.g. -1056>>6)."""
    if isinstance(x, np.ndarray):
        m = (np.abs(x) + (1 << (n - 1))) >> n
        return np.where(x < 0, -m, m)
    return _round2s(x, n) if x >= 0 else -_round2s(-x, n)


def mv_scaling(x, y, mv_row, mv_col, sub_x, sub_y, x_scale, y_scale):
    """startX/Y (1/1024 pel), stepX/Y  [SPEC §7.11.3.3]"""
    half = 1 << (SUBPEL_BITS - 1)
    orig_x = (x << SUBPEL_BITS) + ((2 * mv_col) >> sub_x) + half
    orig_y = (y << SUBPEL_BITS) + ((2 * mv_row) >> sub_y) + half
    base_x = orig_x * x_scale - (half << REF_SCALE_SHIFT)
    base_y = orig_y * y_scale - (half << REF_SCALE_SHIFT)
    off = (1 << (SCALE_SUBPEL_BITS - SUBPEL_BITS)) // 2  # 32
    shift = REF_SCALE_SHIFT + SUBPEL_BITS - SCALE_SUBPEL_BITS  # 8
    start_x = _round2_signed(base_x, shift) + off  # Round2Signed [§7.11.3.3]
    start_y = _round2_signed(base_y, shift) + off
    step_x = _round2s(x_scale, REF_SCALE_SHIFT - SCALE_SUBPEL_BITS)
    step_y = _round2s(y_scale, REF_SCALE_SHIFT - SCALE_SUBPEL_BITS)
    return start_x, start_y, step_x, step_y


def block_inter_pred(ref, x, y, w, h, mv_row, mv_col, filt_x, filt_y,
                     bd, is_compound, ref_w, ref_h, frame_w, frame_h,
                     sub_x, sub_y):
    """Predict a w x h block of one plane from `ref` (2-D int array,
    the reference plane at its own size).  Returns int32 [h][w]:
    clipped pixels when not compound, scaled intermediates otherwise.
    [SPEC §7.11.3.4]

    ref_w/ref_h/frame_w/frame_h are LUMA dims (scaling is derived from
    luma geometry); x/y are plane coords.
    """
    x_scale, y_scale = scale_values(ref_w, ref_h, frame_w, frame_h)
    start_x, start_y, step_x, step_y = mv_scaling(
        x, y, mv_row, mv_col, sub_x, sub_y, x_scale, y_scale)
    r0, r1, _ = inter_rounds(bd, is_compound)

    last_x = ((ref_w + sub_x) >> sub_x) - 1
    last_y = ((ref_h + sub_y) >> sub_y) - 1

    fx = T.SUBPEL_FILTERS[filt_x].astype(np.int64)  # [16][8]
    fy = T.SUBPEL_FILTERS[filt_y].astype(np.int64)

    inter_h = (((h - 1) * step_y + (1 << SCALE_SUBPEL_BITS) - 1)
               >> SCALE_SUBPEL_BITS) + 8

    c = np.arange(w)
    px = start_x + step_x * c                      # 1/1024-pel positions
    col0 = (px >> SCALE_SUBPEL_BITS) - 3           # leftmost tap column
    frac_x = (px >> 6) & 15
    cols = np.clip(col0[:, None] + np.arange(8)[None, :], 0, last_x)  # [w,8]

    rows = np.clip((start_y >> SCALE_SUBPEL_BITS) + np.arange(inter_h) - 3,
                   0, last_y)                      # [inter_h]
    # gather [inter_h, w, 8] source samples and do the horizontal taps
    src = ref[rows[:, None, None], cols[None, :, :]].astype(np.int64)
    interm = _round2s((src * fx[frac_x][None, :, :]).sum(axis=2), r0)

    r = np.arange(h)
    py = (start_y & ((1 << SCALE_SUBPEL_BITS) - 1)) + step_y * r
    row0 = py >> SCALE_SUBPEL_BITS                 # [h]
    frac_y = (py >> 6) & 15
    vsrc = interm[(row0[:, None] + np.arange(8)[None, :])]  # [h, 8, w]
    out = _round2s((vsrc * fy[frac_y][:, :, None]).sum(axis=1), r1)
    if not is_compound:
        out = np.clip(out, 0, (1 << bd) - 1)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Warped motion [SPEC §7.11.3.5]
# ---------------------------------------------------------------------------

DIV_LUT_BITS = 8
DIV_LUT_PREC_BITS = 14
_DIV_LUT = np.array([((1 << 22) + ((256 + f) >> 1)) // (256 + f)
                     for f in range(257)], np.int64)
WARPEDMODEL_PREC_BITS = 16
WARPEDDIFF_PREC_BITS = 10
WARPEDPIXEL_PREC_SHIFTS = 64


def resolve_divisor(d: int):
    """[SPEC §7.11.3.7] -> (divShift, divFactor)"""
    ad = abs(d)
    n = ad.bit_length() - 1
    e = ad - (1 << n)
    if n > DIV_LUT_BITS:
        f = _round2s(e, n - DIV_LUT_BITS)
    else:
        f = e << (DIV_LUT_BITS - n)
    shift = n + DIV_LUT_PREC_BITS
    factor = int(_DIV_LUT[f])
    return shift, -factor if d < 0 else factor


def setup_shear(params):
    """[SPEC §7.11.3.6] -> (valid, alpha, beta, gamma, delta)"""
    alpha0 = np.clip(params[2] - (1 << WARPEDMODEL_PREC_BITS), -32768, 32767)
    beta0 = np.clip(params[3], -32768, 32767)
    div_shift, div_factor = resolve_divisor(params[2])
    v = (params[4] << WARPEDMODEL_PREC_BITS)
    gamma0 = int(np.clip(_round2_signed(v * div_factor, div_shift),
                         -32768, 32767))
    w = params[3] * params[4]
    delta0 = int(np.clip(
        params[5] - _round2_signed(w * div_factor, div_shift) -
        (1 << WARPEDMODEL_PREC_BITS), -32768, 32767))

    def trim(a):
        # round to a multiple of 1 << WARP_PARAM_REDUCE_BITS (6);
        # Round2Signed, NOT floor-round — differs at negative halves
        # (verified against libaom av1_get_shear_params: beta -1056 ->
        # -1088, not -1024)
        return (_round2_signed(a, 6)) * (1 << 6)

    alpha = trim(int(alpha0))
    beta = trim(int(beta0))
    gamma = trim(gamma0)
    delta = trim(delta0)
    warp_valid = (4 * abs(alpha) + 7 * abs(beta) < (1 << WARPEDMODEL_PREC_BITS)) and \
                 (4 * abs(gamma) + 4 * abs(delta) < (1 << WARPEDMODEL_PREC_BITS))
    return warp_valid, alpha, beta, gamma, delta


def warp_block(ref, params, x, y, w, h, bd, is_compound, ref_w, ref_h,
               sub_x, sub_y, alpha, beta, gamma, delta):
    """Warped prediction of a w x h plane block via 8x8 sub-blocks
    (horizontal + vertical shear passes, 8-tap warped filters).
    [SPEC §7.11.3.5 block warp process]"""
    r0, r1, _ = inter_rounds(bd, is_compound)
    out = np.zeros((h, w), np.int64)
    last_x = ((ref_w + sub_x) >> sub_x) - 1
    last_y = ((ref_h + sub_y) >> sub_y) - 1
    filt = T.WARPED_FILTER.astype(np.int64)
    i1h = np.arange(-7, 8)
    i2h = np.arange(-4, 4)
    for j8 in range(0, h, 8):
        for i8 in range(0, w, 8):
            src_x = (x + i8 + 4) << sub_x
            src_y = (y + j8 + 4) << sub_y
            dst_x = int(params[2]) * src_x + int(params[3]) * src_y \
                + int(params[0])
            dst_y = int(params[4]) * src_x + int(params[5]) * src_y \
                + int(params[1])
            x4 = dst_x >> sub_x   # full 2^-16 precision [libaom warp_affine]
            y4 = dst_y >> sub_y
            ix4, sx4 = x4 >> WARPEDMODEL_PREC_BITS, \
                x4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
            iy4, sy4 = y4 >> WARPEDMODEL_PREC_BITS, \
                y4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
            # shift the shear origin to the block corner, then align the
            # subpel base to the trimmed parameter grid
            sx4 = (sx4 + alpha * (-4) + beta * (-4)) & ~63
            sy4 = (sy4 + gamma * (-4) + delta * (-4)) & ~63
            # horizontal pass -> intermediate [15][8]
            sx = sx4 + alpha * (i2h + 4)[None, :] + beta * (i1h + 4)[:, None]
            offs = _round2s(sx, WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            rows = np.clip(iy4 + i1h, 0, last_y)               # [15]
            cols = np.clip(ix4 + i2h[:, None] - 3 + np.arange(8)[None, :],
                           0, last_x)                          # [8 cols, 8 taps]
            src = ref[rows[:, None, None], cols[None, :, :]].astype(np.int64)
            interm = _round2s((src * filt[offs]).sum(axis=2), r0)  # [15,8]
            # vertical pass
            oh = min(8, h - j8)
            ow = min(8, w - i8)
            i1v = np.arange(-4, -4 + oh)
            i2v = np.arange(-4, -4 + ow)
            sy = sy4 + gamma * (i2v + 4)[None, :] + delta * (i1v + 4)[:, None]
            offs_v = _round2s(sy, WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            # sample taps: intermediate[i1 + i3 + 4][i2 + 4]
            tap_rows = i1v[:, None, None] + np.arange(8)[None, None, :] + 4
            vals = interm[tap_rows, (i2v + 4)[None, :, None]]  # [oh,ow,8]
            s = (vals * filt[offs_v]).sum(axis=2)
            out[j8: j8 + oh, i8: i8 + ow] = _round2s(s, r1)
    if not is_compound:
        out = np.clip(out, 0, (1 << bd) - 1)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Compound blends [SPEC §7.11.3.11-3.15]
# ---------------------------------------------------------------------------

def avg_blend(p0, p1, bd):
    _, _, post = inter_rounds(bd, True)
    return np.clip(_round2s(p0.astype(np.int64) + p1, post + 1), 0,
                   (1 << bd) - 1).astype(np.int32)


# Quant_Dist_Weight / Quant_Dist_Lookup [SPEC §7.11.3.15]
QUANT_DIST_WEIGHT = [(2, 3), (2, 5), (2, 7), (1, MAX_FRAME_DISTANCE)]
QUANT_DIST_LOOKUP = [(9, 7), (11, 5), (12, 4), (13, 3)]


def dist_weights(d0: int, d1: int):
    """Distance-weighted compound weights (fwd, bck); d0 = |dist| of ref1,
    d1 = |dist| of ref0 as in the spec.  [SPEC §7.11.3.15]

    libaom's rule (`av1_dist_wtd_comp_weight_assign`): the table's pair
    is read in `order`, and the search stops at the first row whose
    weighted distances cross, in the direction that `order` sets."""
    order = int(d0 <= d1)
    if d0 == 0 or d1 == 0:
        fwd = QUANT_DIST_LOOKUP[3][order]
        bck = QUANT_DIST_LOOKUP[3][1 - order]
        return fwd, bck
    for i in range(3):
        c0 = QUANT_DIST_WEIGHT[i][order]
        c1 = QUANT_DIST_WEIGHT[i][1 - order]
        if (d0 > d1 and d0 * c0 < d1 * c1) or \
                (d0 <= d1 and d0 * c0 > d1 * c1):
            break
    else:
        i = 3
    fwd = QUANT_DIST_LOOKUP[i][order]
    bck = QUANT_DIST_LOOKUP[i][1 - order]
    return fwd, bck


def dist_blend(p0, p1, fwd, bck, bd):
    _, _, post = inter_rounds(bd, True)
    s = fwd * p0.astype(np.int64) + bck * p1
    return np.clip(_round2s(s, post + 4), 0, (1 << bd) - 1).astype(np.int32)


def mask_blend(mask, p0, p1, bd, sub_x, sub_y, is_interintra):
    """Masked blend [SPEC §7.11.3.14].  mask is at LUMA block resolution;
    chroma subsamples it.  For inter-intra, p0 = intra pixels, p1 = inter
    pixels (pixel domain); otherwise both are compound intermediates."""
    if sub_x == 0 and sub_y == 0:
        m = mask.astype(np.int64)
    elif sub_x == 1 and sub_y == 0:
        m = _round2s(mask[:, ::2].astype(np.int64) + mask[:, 1::2], 1)
    elif sub_x == 0 and sub_y == 1:
        m = _round2s(mask[::2, :].astype(np.int64) + mask[1::2, :], 1)
    else:
        m = _round2s(mask[::2, ::2].astype(np.int64) + mask[::2, 1::2] +
                     mask[1::2, ::2] + mask[1::2, 1::2], 2)
    if is_interintra:
        return _round2s(m * p0.astype(np.int64) + (64 - m) * p1, 6) \
            .astype(np.int32)
    _, _, post = inter_rounds(bd, True)
    s = m * p0.astype(np.int64) + (64 - m) * p1
    return np.clip(_round2s(s, post + 6), 0, (1 << bd) - 1).astype(np.int32)


# -- wedge masks [SPEC §7.11.3.11] -----------------------------------------

MASK_MASTER_SIZE = 64
WEDGE_HORIZONTAL, WEDGE_VERTICAL, WEDGE_OBLIQUE27, WEDGE_OBLIQUE63, \
    WEDGE_OBLIQUE117, WEDGE_OBLIQUE153 = range(6)

# per-bsize wedge codebooks: (direction, x_off, y_off) x 16
# [SPEC §9.3 Wedge_Codebook]; class 0 = w > h, 1 = h > w, 2 = square
_CODEBOOK_BASE = [
    (WEDGE_OBLIQUE27, 4, 4), (WEDGE_OBLIQUE63, 4, 4),
    (WEDGE_OBLIQUE117, 4, 4), (WEDGE_OBLIQUE153, 4, 4),
]
WEDGE_CODEBOOK = [
    _CODEBOOK_BASE + [
        (WEDGE_VERTICAL, 2, 4), (WEDGE_VERTICAL, 4, 4),
        (WEDGE_VERTICAL, 6, 4), (WEDGE_HORIZONTAL, 4, 4),
        (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
        (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
        (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
        (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)],
    _CODEBOOK_BASE + [
        (WEDGE_HORIZONTAL, 4, 2), (WEDGE_HORIZONTAL, 4, 4),
        (WEDGE_HORIZONTAL, 4, 6), (WEDGE_VERTICAL, 4, 4),
        (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
        (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
        (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
        (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)],
    _CODEBOOK_BASE + [
        (WEDGE_HORIZONTAL, 4, 2), (WEDGE_HORIZONTAL, 4, 6),
        (WEDGE_VERTICAL, 2, 4), (WEDGE_VERTICAL, 6, 4),
        (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
        (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
        (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
        (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)],
]

_master_cache = {}


def _master_masks():
    """MasterMask[6][64][64] built from the 1-D profiles
    [SPEC §7.11.3.11]."""
    if "m" in _master_cache:
        return _master_cache["m"]
    w = MASK_MASTER_SIZE
    master = np.zeros((6, w, w), np.int32)
    j = np.arange(w)
    for i in range(0, w, 2):
        shift_e = (w // 4) - (i // 2)
        shift_o = shift_e - 1
        master[WEDGE_OBLIQUE63, i] = T.WEDGE_MASTER_OBLIQUE_EVEN[
            np.clip(j - shift_e, 0, w - 1)]
        master[WEDGE_OBLIQUE63, i + 1] = T.WEDGE_MASTER_OBLIQUE_ODD[
            np.clip(j - shift_o, 0, w - 1)]
        master[WEDGE_VERTICAL, i] = T.WEDGE_MASTER_VERTICAL[j]
        master[WEDGE_VERTICAL, i + 1] = T.WEDGE_MASTER_VERTICAL[j]
    ob63 = master[WEDGE_OBLIQUE63]
    master[WEDGE_OBLIQUE27] = ob63.T
    master[WEDGE_OBLIQUE117] = (64 - ob63)[:, ::-1]
    master[WEDGE_OBLIQUE153] = (64 - ob63).T[::-1, :]
    master[WEDGE_HORIZONTAL] = master[WEDGE_VERTICAL].T
    _master_cache["m"] = master
    return master


def wedge_mask(bw: int, bh: int, wedge_idx: int, wedge_sign: int):
    """Block wedge mask (luma resolution), values 0..64.
    [SPEC §7.11.3.11]"""
    cls = 0 if bw > bh else (1 if bh > bw else 2)
    direction, x_off, y_off = WEDGE_CODEBOOK[cls][wedge_idx]
    master = _master_masks()[direction]
    xoff = MASK_MASTER_SIZE // 2 - ((x_off * bw) >> 3)
    yoff = MASK_MASTER_SIZE // 2 - ((y_off * bh) >> 3)
    m = master[yoff: yoff + bh, xoff: xoff + bw]
    # flipSign: the sign whose mask is the master's own window, 1 where
    # the window's first row and column average below 32; the other
    # sign takes 64 - master [SPEC §7.11.3.11; libaom init_wedge_signs]
    edge = int(m[0, :].sum()) + int(m[1:, 0].sum())
    flip = int((edge + (bw + bh - 1) // 2) // (bw + bh - 1) < 32)
    if wedge_sign != flip:
        return 64 - m
    return m


def diffwtd_mask(p0, p1, mask_type: int, bd: int):
    """Difference-weighted mask from the compound intermediates.
    [SPEC §7.11.3.12]"""
    r0, r1, _ = inter_rounds(bd, True)
    diff = np.abs(p0.astype(np.int64) - p1)
    diff = _round2s(diff, (bd - 8) + (14 - r0 - r1))
    m = np.clip(38 + (diff >> 4), 0, 64)
    return (64 - m) if mask_type else m


def interintra_mask(mode: int, bw: int, bh: int):
    """Smooth inter-intra blend mask (a wedge inter-intra block takes
    `wedge_mask` with sign 0): the mask weights the INTRA prediction.
    mode: 0=DC, 1=V, 2=H, 3=SMOOTH [SPEC §7.11.3.13].  Built at the
    plane block's own size bw x bh, the 1-D weights stepped by
    sizeScale = 128 / max(bw, bh) (libaom's ii_size_scales)."""
    ii = T.II_WEIGHTS_1D
    scale = 128 // max(bw, bh)
    if mode == 0:  # II_DC_PRED
        return np.full((bh, bw), 32, np.int32)
    if mode == 1:  # II_V_PRED: weight decays downward
        w = ii[np.arange(bh) * scale]
        return np.broadcast_to(w[:, None], (bh, bw)).astype(np.int32)
    if mode == 2:  # II_H_PRED
        w = ii[np.arange(bw) * scale]
        return np.broadcast_to(w[None, :], (bh, bw)).astype(np.int32)
    # II_SMOOTH_PRED: min distance from top/left
    iy, ix = np.arange(bh), np.arange(bw)
    return ii[np.minimum(iy[:, None], ix[None, :]) * scale] \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# OBMC [SPEC §7.11.3.9-3.10]
# ---------------------------------------------------------------------------

_OBMC_MASKS = {2: T.OBMC_MASK_2, 4: T.OBMC_MASK_4, 8: T.OBMC_MASK_8,
               16: T.OBMC_MASK_16, 32: T.OBMC_MASK_32}


def obmc_mask(length: int):
    return _OBMC_MASKS[length]


def obmc_blend_above(pred, obmc_pred, length):
    """Blend the top `length` rows: mask weights the CURRENT pred.
    [SPEC §7.11.3.10 overlap blending, vertical]"""
    m = obmc_mask(length).astype(np.int64)[:, None]
    top = pred[:length].astype(np.int64)
    pred[:length] = _round2s(m * top + (64 - m) * obmc_pred[:length], 6)
    return pred


def obmc_blend_left(pred, obmc_pred, length):
    m = obmc_mask(length).astype(np.int64)[None, :]
    left = pred[:, :length].astype(np.int64)
    pred[:, :length] = _round2s(m * left + (64 - m) * obmc_pred[:, :length],
                                6)
    return pred
