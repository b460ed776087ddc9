"""Film grain synthesis [SPEC §7.18.3] — NumPy spec model.

Grain templates (73x82 luma, AR-filtered Gaussian noise), piecewise
scaling LUTs, and 32x32-block application with stripe/block overlap
blending.  Output-side only: the decoded reference frames never carry
grain.
"""
import numpy as np

from av1dec_tpu_torch.ops.gaussian_seq import GAUSSIAN_SEQUENCE

GRAIN_W, GRAIN_H = 82, 73
CHROMA_W = {0: 82, 1: 44}
CHROMA_H = {0: 73, 1: 38}


def _rand(state, bits):
    r = state[0]
    bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
    r = (r >> 1) | (bit << 15)
    state[0] = r
    return (r >> (16 - bits)) & ((1 << bits) - 1)


def _round2(x, n):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _ar_pos(lag):
    """(deltaRow, deltaCol) scan order for AR coefficients."""
    pos = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            pos.append((dr, dc))
    return pos


def generate_grain(g, bd, sub_x, sub_y, mono):
    """Returns (luma_grain, cb_grain, cr_grain) int arrays.
    [SPEC §7.18.3.3]"""
    shift = 12 - bd + g["grain_scale_shift"]
    gmin = -(1 << (bd - 1))
    gmax = (1 << (bd - 1)) - 1
    lag = g["ar_coeff_lag"]
    num_y = g["num_y_points"]

    state = [g["grain_seed"]]
    luma = np.zeros((GRAIN_H, GRAIN_W), np.int64)
    for y in range(GRAIN_H):
        for x in range(GRAIN_W):
            v = GAUSSIAN_SEQUENCE[_rand(state, 11)] if num_y else 0
            luma[y, x] = _round2(v, shift)
    pos = _ar_pos(lag)
    coeffs = g["ar_coeffs_y"]
    if num_y:
        for y in range(3, GRAIN_H):
            for x in range(3, GRAIN_W - 3):
                s = 0
                for k, (dr, dc) in enumerate(pos):
                    s += luma[y + dr, x + dc] * coeffs[k]
                luma[y, x] = min(gmax, max(
                    gmin, luma[y, x] + _round2(s, g["ar_coeff_shift"])))

    if mono:
        return luma, None, None

    cw, ch = CHROMA_W[sub_x], CHROMA_H[sub_y]
    out_c = []
    for plane, xor in (("cb", 0xb524), ("cr", 0x49d8)):
        n_pts = g[f"num_{plane}_points"]
        need = n_pts > 0 or g["chroma_scaling_from_luma"]
        grain = np.zeros((ch, cw), np.int64)
        state = [g["grain_seed"] ^ xor]
        for y in range(ch):
            for x in range(cw):
                v = GAUSSIAN_SEQUENCE[_rand(state, 11)] if need else 0
                grain[y, x] = _round2(v, shift)
        if need:
            ccoef = g[f"ar_coeffs_{plane}"]
            for y in range(3, ch):
                for x in range(3, cw - 3):
                    s = 0
                    for k, (dr, dc) in enumerate(pos):
                        s += grain[y + dr, x + dc] * ccoef[k]
                    if num_y:
                        # coupled luma term at the centre position
                        lx = ((x - 3) << sub_x) + 3
                        ly = ((y - 3) << sub_y) + 3
                        lsum = 0
                        for i in range(sub_y + 1):
                            for j in range(sub_x + 1):
                                lsum += luma[ly + i, lx + j]
                        lv = _round2(lsum, sub_x + sub_y)
                        s += lv * ccoef[len(pos)]
                    grain[y, x] = min(gmax, max(
                        gmin, grain[y, x] + _round2(s, g["ar_coeff_shift"])))
        out_c.append(grain)
    return luma, out_c[0], out_c[1]


def _scaling_lut(values, scalings, n):
    """256-entry piecewise-linear scaling LUT [SPEC §7.18.3.5]."""
    lut = np.zeros(256, np.int64)
    if n == 0:
        return lut
    lut[: values[0] + 1] = scalings[0]
    for j in range(n - 1):
        dx = values[j + 1] - values[j]
        dy = scalings[j + 1] - scalings[j]
        if dx <= 0:
            continue
        delta = dy * ((65536 + (dx >> 1)) // dx)
        for k in range(dx):
            lut[values[j] + k] = scalings[j] + ((k * delta + 32768) >> 16)
    lut[values[n - 1]:] = scalings[n - 1]
    return lut


def _scale(lut, index, bd):
    """scale_lut [SPEC §7.18.3.5] with sub-entry interpolation for bd>8."""
    shift = bd - 8
    x = index >> shift
    rem = index - (x << shift)
    if bd == 8:
        return lut[np.clip(x, 0, 255)]
    x = np.clip(x, 0, 255)
    start = lut[x]
    end = lut[np.minimum(x + 1, 255)]
    out = start + (((end - start) * rem + (1 << (shift - 1))) >> shift)
    return np.where(x == 255, start, out)


# overlap blend weights: [subsampled][position][old, new]
_W = {0: [[27, 17], [17, 27]], 1: [[23, 22]]}


def _offsets(randval, sub_x, sub_y):
    offx = 3 + (2 >> sub_x) * (3 + (randval >> 4))
    offy = 3 + (2 >> sub_y) * (3 + (randval & 0xF))
    return offy, offx


def apply_grain(planes, g, bd, sub_x, sub_y):
    """Add film grain to output planes (returns new list). [SPEC §7.18.3]"""
    if not g.get("apply_grain"):
        return planes
    mono = len(planes) == 1
    luma_g, cb_g, cr_g = generate_grain(g, bd, sub_x, sub_y, mono)
    lut_y = _scaling_lut(g["point_y_value"], g["point_y_scaling"],
                         g["num_y_points"])
    lut_c = []
    if not mono:
        for pl in ("cb", "cr"):
            if g["chroma_scaling_from_luma"]:
                lut_c.append(lut_y)
            else:
                lut_c.append(_scaling_lut(g[f"point_{pl}_value"],
                                          g[f"point_{pl}_scaling"],
                                          g[f"num_{pl}_points"]))

    src_y = np.asarray(planes[0]).astype(np.int64)
    h, w = src_y.shape
    out = [p.copy() if hasattr(p, "copy") else np.array(p) for p in planes]
    out = [np.asarray(p).astype(np.int64) for p in out]

    gmin = -(128 << (bd - 8))
    gmax = (128 << (bd - 8)) - 1
    sshift = g["grain_scaling"]
    overlap = g["overlap_flag"]
    clip = g["clip_to_restricted_range"]
    lo = 16 << (bd - 8) if clip else 0
    hi_y = (235 << (bd - 8)) if clip else (1 << bd) - 1
    hi_c = (240 << (bd - 8)) if clip else (1 << bd) - 1

    rows32 = (h + 31) // 32
    cols32 = (w + 31) // 32

    # per block-row seeds [libaom/dav1d row seed derivation]
    def row_seeds(row_num, nrows):
        seeds = []
        for i in range(nrows):
            s = g["grain_seed"]
            s ^= (((row_num - i) * 37 + 178) & 0xFF) << 8
            s ^= ((row_num - i) * 173 + 105) & 0xFF
            seeds.append([s])
        return seeds

    # gather offsets per (row, col): offs[row][col][by] with by=0 current
    # stripe, by=1 the stripe above
    offs = [[None] * cols32 for _ in range(rows32)]
    for row in range(rows32):
        nrows = 2 if (overlap and row > 0) else 1
        seeds = row_seeds(row, nrows)
        prev = [None] * nrows
        for col in range(cols32):
            cur = [_rand(seeds[i], 8) for i in range(nrows)]
            offs[row][col] = (cur, prev)
            prev = cur

    def sample(grain, randval, by, bx, ys, xs, sx, sy):
        offy, offx = _offsets(randval, sx, sy)
        return grain[np.ix_(offy + (32 >> sy) * by + ys,
                            offx + (32 >> sx) * bx + xs)]

    def grain_block(grain, row, col, bh, bw, sx, sy):
        """Assembled (bh, bw) grain for one block incl. overlap blends."""
        cur, prev = offs[row][col]
        ys = np.arange(bh)
        xs = np.arange(bw)
        gcur = sample(grain, cur[0], 0, 0, ys, xs, sx, sy)
        nx = (2 >> sx) if (overlap and col > 0) else 0
        ny = (2 >> sy) if (overlap and row > 0) else 0
        wx = _W[sx]
        wy = _W[sy]
        out_b = gcur.copy()
        if nx:
            old = sample(grain, prev[0], 0, 1, ys, xs[:nx], sx, sy)
            for x in range(min(nx, bw)):
                out_b[:, x] = np.clip(_round2(
                    old[:, x] * wx[x][0] + gcur[:, x] * wx[x][1], 5),
                    gmin, gmax)
        if ny:
            top = sample(grain, cur[-1], 1, 0, ys[:ny], xs, sx, sy)
            if nx:
                top_old = sample(grain, prev[-1], 1, 1, ys[:ny], xs[:nx],
                                 sx, sy)
                for x in range(min(nx, bw)):
                    top[:, x] = _round2(
                        top_old[:, x] * wx[x][0] + top[:, x] * wx[x][1], 5)
                top[:, :nx] = np.clip(top[:, :nx], gmin, gmax)
            for y in range(min(ny, bh)):
                out_b[y, :] = _round2(
                    top[y, :] * wy[y][0] + out_b[y, :] * wy[y][1], 5)
        return np.clip(out_b, gmin, gmax)

    # ---- luma
    if g["num_y_points"] > 0:
        for row in range(rows32):
            for col in range(cols32):
                y0, x0 = row * 32, col * 32
                bh, bw = min(32, h - y0), min(32, w - x0)
                gb = grain_block(luma_g, row, col, bh, bw, 0, 0)
                srcb = src_y[y0: y0 + bh, x0: x0 + bw]
                noise = _round2(_scale(lut_y, srcb, bd) * gb, sshift)
                out[0][y0: y0 + bh, x0: x0 + bw] = np.clip(
                    srcb + noise, lo, hi_y)

    # ---- chroma
    if not mono:
        ch = (h + sub_y) >> sub_y
        cw = (w + sub_x) >> sub_x
        bh32, bw32 = 32 >> sub_y, 32 >> sub_x
        biases = [
            (g["cb_mult"] - 128, g["cb_luma_mult"] - 128,
             g["cb_offset"] - 256),
            (g["cr_mult"] - 128, g["cr_luma_mult"] - 128,
             g["cr_offset"] - 256),
        ]
        for pi, grain in ((1, cb_g), (2, cr_g)):
            n_pts = g["num_cb_points" if pi == 1 else "num_cr_points"]
            if not (n_pts > 0 or g["chroma_scaling_from_luma"]):
                continue
            mult, lmult, offset = biases[pi - 1]
            srcp = np.asarray(planes[pi]).astype(np.int64)
            for row in range(rows32):
                for col in range(cols32):
                    y0, x0 = row * bh32, col * bw32
                    bh, bw = min(bh32, ch - y0), min(bw32, cw - x0)
                    if bh <= 0 or bw <= 0:
                        continue
                    gb = grain_block(grain, row, col, bh, bw, sub_x, sub_y)
                    srcb = srcp[y0: y0 + bh, x0: x0 + bw]
                    # co-located luma average (horizontal only)
                    ly = (np.arange(bh) + y0) << sub_y
                    lx = (np.arange(bw) + x0) << sub_x
                    ly = np.minimum(ly, h - 1)
                    lavg = src_y[np.ix_(ly, np.minimum(lx, w - 1))]
                    if sub_x:
                        lavg = (lavg + src_y[np.ix_(
                            ly, np.minimum(lx + 1, w - 1))] + 1) >> 1
                    if g["chroma_scaling_from_luma"]:
                        index = lavg
                    else:
                        merged = (lavg * lmult + srcb * mult) >> 6
                        index = np.clip(
                            merged + offset * (1 << (bd - 8)),
                            0, (1 << bd) - 1)
                    noise = _round2(
                        _scale(lut_c[pi - 1], index, bd) * gb, sshift)
                    out[pi][y0: y0 + bh, x0: x0 + bw] = np.clip(
                        srcb + noise, lo, hi_c)

    dt = planes[0].dtype if hasattr(planes[0], "dtype") else np.uint8
    return [p.astype(dt) for p in out]
