"""Compound prediction in av1dec_tpu_torch, on the CPU:

- `ops/spec/inter.dist_weights` follows libaom's
  `av1_dist_wtd_comp_weight_assign` over every pair of clamped
  distances (the reference's rule does not: its weights differ from
  libaom's on the committed `c4` stream);
- the MC pass (B6) on the compound lanes of the committed compound
  streams (average and distance-weighted, two reference lists) equals
  the JAX package's `run_mc` on the same lanes and reference pieces;
- `device_inter.ineligible_reason` takes average and
  distance-weighted compound frames and refuses difference-weighted
  ones, as the reference's `frame_eligible` does;
- the wedge masks (compound and inter-intra) and the smooth inter-intra
  masks equal libaom's, built here from libaom's own tables and rules
  (the reference's differ: its sign flips, its even and odd oblique
  masters, which it swaps, its vertical master and the wide blocks'
  vertical codebook entries; its smooth masks skip the size scale and
  are subsampled for chroma).
(The streams themselves decode equal to libaom in
tests/test_torch_slice.py and tests/test_torch_recon.py.)
"""
import numpy as np
import pytest

from torch_port_helpers import decode_capture, jax_refs, parse

from test_torch_mc import _jax_mc, _port_mc

MAX_FRAME_DISTANCE = 31
QUANT_DIST_WEIGHT = [(2, 3), (2, 5), (2, 7), (1, MAX_FRAME_DISTANCE)]
QUANT_DIST_LOOKUP = [(9, 7), (11, 5), (12, 4), (13, 3)]


def _libaom_weights(d0, d1):
    """libaom's av1_dist_wtd_comp_weight_assign on clamped distances:
    d0 of the second reference (fwd_offset side), d1 of the first."""
    order = int(d0 <= d1)
    if d0 == 0 or d1 == 0:
        return (QUANT_DIST_LOOKUP[3][order], QUANT_DIST_LOOKUP[3][1 - order])
    i = 0
    while i < 3:
        c0 = QUANT_DIST_WEIGHT[i][order]
        c1 = QUANT_DIST_WEIGHT[i][1 - order]
        if (d0 > d1 and d0 * c0 < d1 * c1) or \
                (d0 <= d1 and d0 * c0 > d1 * c1):
            break
        i += 1
    return QUANT_DIST_LOOKUP[i][order], QUANT_DIST_LOOKUP[i][1 - order]


def test_dist_weights_follow_libaom():
    from av1dec_tpu.ops.spec import inter as jinter
    from av1dec_tpu_torch.ops.spec import inter as tinter
    differ = 0
    for d0 in range(MAX_FRAME_DISTANCE + 1):
        for d1 in range(MAX_FRAME_DISTANCE + 1):
            want = _libaom_weights(d0, d1)
            assert tinter.dist_weights(d0, d1) == want, (d0, d1)
            differ += jinter.dist_weights(d0, d1) != want
    assert differ > 0  # the reference's rule, repaired in the port


@pytest.mark.parametrize("name", ["c4", "c5"])
def test_compound_mc_lanes_match_jax(name, native_lib):
    """The port's InterPlan lanes (from the port's parse, which differs
    from the reference's on compound frames) through both MC passes."""
    from av1dec_tpu_torch.ops.kernels.mc import _MF
    _, _, drs = decode_capture(name)
    comp = dist = 0
    for dr in drs:
        ip = dr._inter_plan
        if ip is None:
            continue
        ref_np = np.concatenate([np.asarray(p).reshape(-1)
                                 for p in ip.ref_np])
        frame0 = np.zeros(dr.sch.flat_len + 64, np.int32)
        want = _jax_mc(frame0, ref_np, ip.lanes, dr.sch.bd)
        got = _port_mc(frame0, ip.ref_np, ip.lanes, dr.sch.bd)
        np.testing.assert_array_equal(got, want)
        for (_, c), rows in ip.lanes.items():
            if c and len(rows):
                comp += len(rows)
                dist += int((rows[:, _MF["w0"]] != 1).sum())
    assert comp > 0
    assert (dist > 0) == (name == "c4")


@pytest.mark.parametrize("name", ["c4", "masked"])
def test_compound_routing_matches_reference_rule(name, native_lib):
    from av1dec_tpu.pipeline.device_inter import frame_eligible
    from av1dec_tpu_torch.pipeline.device_inter import ineligible_reason
    _, stats, drs = decode_capture(name)
    seen = {True: 0, False: 0}
    for (seq, hdr, plans), dr in zip(parse(name, "torch"), drs):
        if hdr.get("frame_is_intra", 1):
            continue
        refs = jax_refs(dr.refs)
        ok = ineligible_reason(hdr, plans, refs, 3) is None
        assert ok == frame_eligible(hdr, plans, refs, 3)
        assert ok == dr.supported()
        g = plans.grid
        inter = np.asarray(g("is_inter")) != 0
        if (np.asarray(g("ref1"))[inter] > 0).any():
            seen[ok] += 1
    assert seen[True] > 0
    assert (seen[False] > 0) == (name == "masked")


# libaom's wedge masters (reconinter.c) and codebooks, and its
# ii_size_scales, written out here as the independent reference
_EVEN = [0] * 28 + [1, 4, 11, 27, 46, 58, 62, 63] + [64] * 28
_ODD = [0] * 28 + [1, 2, 6, 18, 37, 53, 60, 63] + [64] * 28
_VERT = [0] * 29 + [2, 7, 21, 43, 57, 62] + [64] * 29
H_, V_, O27, O63, O117, O153 = range(6)
_TAIL = [(O27, 4, 2), (O27, 4, 6), (O153, 4, 2), (O153, 4, 6),
         (O63, 2, 4), (O63, 6, 4), (O117, 2, 4), (O117, 6, 4)]
_HEAD = [(O27, 4, 4), (O63, 4, 4), (O117, 4, 4), (O153, 4, 4)]
_BOOK = {  # h > w, h < w, h == w
    "hgtw": _HEAD + [(H_, 4, 2), (H_, 4, 4), (H_, 4, 6), (V_, 4, 4)] + _TAIL,
    "hltw": _HEAD + [(V_, 2, 4), (V_, 4, 4), (V_, 6, 4), (H_, 4, 4)] + _TAIL,
    "heqw": _HEAD + [(H_, 4, 2), (H_, 4, 6), (V_, 2, 4), (V_, 6, 4)] + _TAIL,
}
WEDGE_SIZES = [(8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
               (32, 32), (8, 32), (32, 8)]


def _masters():
    """libaom's init_wedge_master_masks, index [0] (the masters)."""
    n = 64
    m = np.zeros((6, n, n), np.int64)
    shift = n // 4
    for i in range(0, n, 2):
        for j in range(n):
            m[O63, i, j] = _EVEN[min(max(j - shift, 0), n - 1)]
        shift -= 1
        for j in range(n):
            m[O63, i + 1, j] = _ODD[min(max(j - shift, 0), n - 1)]
        m[V_, i] = m[V_, i + 1] = _VERT
    for i in range(n):
        for j in range(n):
            msk = m[O63, i, j]
            m[O27, j, i] = msk
            m[O117, i, n - 1 - j] = 64 - msk
            m[O153, n - 1 - j, i] = 64 - msk
            m[H_, j, i] = m[V_, i, j]
    return m


def _libaom_wedge(masters, bw, bh, idx, sign):
    book = _BOOK["hgtw" if bh > bw else "hltw" if bh < bw else "heqw"]
    d, xo, yo = book[idx]
    y0, x0 = 32 - ((yo * bh) >> 3), 32 - ((xo * bw) >> 3)
    win = masters[d, y0:y0 + bh, x0:x0 + bw]
    avg = (int(win[0].sum()) + int(win[1:, 0].sum()) +
           (bw + bh - 1) // 2) // (bw + bh - 1)
    flip = int(avg < 32)          # libaom init_wedge_signs
    return win if sign == flip else 64 - win


def test_wedge_masks_follow_libaom():
    from av1dec_tpu.ops.spec import inter as jinter
    from av1dec_tpu_torch.ops.spec import inter as tinter
    masters = _masters()
    differ = 0
    for bw, bh in WEDGE_SIZES:
        for idx in range(16):
            for sign in (0, 1):
                want = _libaom_wedge(masters, bw, bh, idx, sign)
                got = tinter.wedge_mask(bw, bh, idx, sign)
                np.testing.assert_array_equal(got, want)
                differ += not np.array_equal(
                    jinter.wedge_mask(bw, bh, idx, sign), want)
    assert differ > 0  # the reference's masks, repaired in the port


# libaom's ii_size_scales by (w, h)
II_SIZE_SCALES = {(4, 4): 32, (4, 8): 16, (8, 4): 16, (8, 8): 16,
                  (8, 16): 8, (16, 8): 8, (16, 16): 8, (16, 32): 4,
                  (32, 16): 4, (32, 32): 4, (4, 16): 8, (16, 4): 8,
                  (8, 32): 4, (32, 8): 4}


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_interintra_smooth_masks_follow_libaom(mode):
    """libaom's build_smooth_interintra_mask at each plane block size
    (chroma blocks included: the mask is built at their own size)."""
    from av1dec_tpu_torch.ops import inter_tables as T
    from av1dec_tpu_torch.ops.spec import inter as tinter
    w1d = T.II_WEIGHTS_1D
    for (bw, bh), scale in II_SIZE_SCALES.items():
        i, j = np.mgrid[:bh, :bw]
        want = {0: np.full((bh, bw), 32), 1: w1d[i * scale],
                2: w1d[j * scale],
                3: w1d[np.minimum(i, j) * scale]}[mode]
        got = tinter.interintra_mask(mode, bw, bh)
        np.testing.assert_array_equal(got, want)
