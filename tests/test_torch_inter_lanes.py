"""The port's whole-frame lane builder (`device_inter.InterPlan.
_build_lanes`) against the JAX package's per-block loop, row for row and
key for key, on seeded synthetic mode grids: every chroma format, bit
depth and block size, sub-8x8 chroma with all-inter and with intra
neighbours, single-reference, average and distance-weighted compound
lanes with order hints on and off, every interpolation pair and negative
odd motion vectors.  The reference is bound to the port's
`ops/spec/inter`, so that both take libaom's distance weights.  Also the
`lanes.rows` and `lanes.pieces` counters."""
import types

import numpy as np
import pytest

from av1dec_tpu_torch import tracing
from av1dec_tpu_torch.ops.spec import inter as port_inter
from av1dec_tpu_torch.pipeline import device_inter as tdi

MI_ROWS, MI_COLS = 110, 158  # partial superblocks at the right and bottom
SB = 32                    # 128x128 superblocks, in 4x4 units
FIELDS = ("is_inter", "by", "bx", "bsize", "ref0", "ref1", "interp",
          "mv0y", "mv0x", "mv1y", "mv1x", "compound_type")
BSIZE = {(w, h): i for i, (w, h) in enumerate(zip(tdi.BLOCK_W4,
                                                  tdi.BLOCK_H4))}
# (sub_x, sub_y, planes)
FORMATS = {"420": (1, 1, 3), "422": (1, 0, 3), "444": (0, 0, 3),
           "mono": (1, 1, 1)}


def _partition(rng, out, y, x, n):
    """The blocks (by, bx, w4, h4) of the n x n square at (y, x), split
    at random as AV1's partitions split, forced where half of the square
    lies outside the frame [SPEC §5.11.4]."""
    if y >= MI_ROWS or x >= MI_COLS:
        return
    if n == 1:
        out.append((y, x, 1, 1))
        return
    half = n // 2
    rows, cols = y + half < MI_ROWS, x + half < MI_COLS
    if rows and cols:
        kinds = ["none", "horz", "vert", "split", "split"]
        if 4 <= n <= 16:
            kinds += ["horz4", "vert4"]
    else:
        kinds = ["split"] + (["horz"] if cols else ["vert"] if rows else [])
    kind = kinds[rng.integers(len(kinds))]
    if kind == "split":
        for dy in (0, half):
            for dx in (0, half):
                _partition(rng, out, y + dy, x + dx, half)
        return
    parts = {"none": 1, "horz": 2, "vert": 2, "horz4": 4, "vert4": 4}[kind]
    step = n // parts
    for i in range(parts):
        if kind.startswith("vert"):
            if x + i * step < MI_COLS:
                out.append((y, x + i * step, step, n))
        elif y + i * step < MI_ROWS:
            out.append((y + i * step, x, n, step))


def _draw(rng):
    """(blocks, grid) of one frame: 4 in 5 blocks inter, 2 in 5 of those
    compound (average or distance-weighted), references 1-7, any
    interpolation pair, motion vectors in [-2048, 2048)."""
    blocks = []
    for y in range(0, MI_ROWS, SB):
        for x in range(0, MI_COLS, SB):
            _partition(rng, blocks, y, x, SB)
    grid = {f: np.zeros((MI_ROWS, MI_COLS), np.int16) for f in FIELDS}
    for by, bx, w4, h4 in blocks:
        inter = rng.random() < 0.8
        comp = inter and rng.random() < 0.4
        vals = {
            "is_inter": int(inter), "by": by, "bx": bx,
            "bsize": BSIZE[(w4, h4)],
            "ref0": rng.integers(1, 8) if inter else 0,
            "ref1": rng.integers(1, 8) if comp else rng.choice((-1, 0)),
            "interp": rng.integers(4) * 16 + rng.integers(4),
            "compound_type": rng.integers(2) if comp else 0,
        }
        for f in ("mv0y", "mv0x", "mv1y", "mv1x"):
            vals[f] = rng.integers(-2048, 2048)
        for f, v in vals.items():
            grid[f][by:by + h4, bx:bx + w4] = v
    return blocks, grid


def _frame(seed):
    """The first frame `seed` draws whose inter blocks take every block
    size."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        blocks, grid = _draw(rng)
        inter = grid["is_inter"] != 0
        if len(np.unique(grid["bsize"][inter])) == len(BSIZE):
            return blocks, grid
    raise RuntimeError(f"seed {seed}: no frame with every block size")


def _plans(grid):
    return types.SimpleNamespace(grid=grid.__getitem__, mi_rows=MI_ROWS,
                                 mi_cols=MI_COLS)


def _sch(fmt, bd):
    sub_x, sub_y, planes = FORMATS[fmt]
    w, h = MI_COLS * 4 + 32, MI_ROWS * 4 + 32
    dims = [(h, w)] + [(h >> sub_y, w >> sub_x)] * (planes - 1)
    base = np.cumsum([0] + [a * b for a, b in dims])[:planes].tolist()
    return types.SimpleNamespace(num_planes=planes, sub_x=sub_x,
                                 sub_y=sub_y, bd=bd, plane_base=base,
                                 alloc_dims=dims)


def _layout(sch):
    """A packed layout of references 1-7: distinct offsets, strides and
    last columns and rows a plane."""
    out, off = {}, 0
    for r in range(1, 8):
        for pl, (h, w) in enumerate(sch.alloc_dims):
            out[(r, pl)] = (off, w + r, w - 33 - r, h - 33 + r)
            off += h * (w + r)
    return out


def _hdr(seed, enable_hint):
    rng = np.random.default_rng(seed + 1)
    return {"order_hint": int(rng.integers(128)),
            "order_hints": [int(v) for v in rng.integers(128, size=8)],
            "order_hint_bits": 7, "enable_order_hint_seq": enable_hint}


def _lanes(module, sch, hdr, grid):
    ip = object.__new__(module.InterPlan)
    ip.sch, ip.bd, ip._layout = sch, sch.bd, _layout(sch)
    return ip._build_lanes(None, hdr, _plans(grid), sch)


def _sub8x8(blocks, grid, sch):
    """(chroma pieces, moved chroma units kept whole because they cover
    an intra mi) of the frame's inter blocks, counted a plane."""
    pieces = whole = 0
    for by, bx, w4, h4 in blocks:
        if not grid["is_inter"][by, bx] or sch.num_planes == 1:
            continue
        if not ((by & 1 or not h4 & 1 or not sch.sub_y) and
                (bx & 1 or not w4 & 1 or not sch.sub_x)):
            continue
        row0 = by & ~1 if sch.sub_y and h4 == 1 else by
        col0 = bx & ~1 if sch.sub_x and w4 == 1 else bx
        if (row0, col0) == (by, bx):
            continue
        if (grid["ref0"][row0:by + h4, col0:bx + w4] <= 0).any():
            whole += sch.num_planes - 1
        else:
            pieces += (sch.num_planes - 1) * (by - row0 + 1) * \
                (bx - col0 + 1)
    return pieces, whole


@pytest.mark.parametrize("enable_hint", [0, 1])
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_lanes_match_reference_loop(monkeypatch, fmt, bd, enable_hint):
    from av1dec_tpu.pipeline import device_inter as jdi
    monkeypatch.setattr(jdi, "I", port_inter)
    assert jdi.MC_FIELDS == tdi.MC_FIELDS
    seed = 1000 * bd + 10 * sorted(FORMATS).index(fmt) + enable_hint
    blocks, grid = _frame(seed)
    sch, hdr = _sch(fmt, bd), _hdr(seed, enable_hint)
    want = _lanes(jdi, sch, hdr, grid)
    got = _lanes(tdi, sch, hdr, grid)
    assert list(got) == list(want)
    for key, rows in want.items():
        assert got[key].dtype == np.int64
        np.testing.assert_array_equal(got[key], rows, err_msg=str(key))
    # what the frame exercises
    inter = grid["is_inter"] != 0
    assert set(grid["bsize"][inter].tolist()) == set(range(22))
    assert set(grid["interp"][inter].tolist()) == set(
        a * 16 + b for a in range(4) for b in range(4))
    mv = np.stack([grid[f][inter] for f in ("mv0y", "mv0x")])
    assert ((mv < 0) & (mv % 2 == 1)).any()
    comp = inter & (grid["ref1"] > 0)
    assert set(grid["compound_type"][comp].tolist()) == {0, 1}
    assert (inter & (grid["ref1"] <= 0)).any()
    pieces, whole = _sub8x8(blocks, grid, sch)
    if sch.num_planes > 1 and (sch.sub_x or sch.sub_y):
        assert pieces and whole


@pytest.mark.parametrize("fmt", ["420", "mono"])
def test_lane_counters(fmt):
    """`lanes.rows` counts the rows returned and `lanes.pieces` the
    sub-8x8 chroma pieces among them, in the thread's tracing unit."""
    blocks, grid = _frame(7)
    sch = _sch(fmt, 8)
    with tracing.unit(tracing.Unit(0, 0)) as u:
        lanes = _lanes(tdi, sch, _hdr(7, 1), grid)
    assert u.counts["lanes.rows"] == sum(len(v) for v in lanes.values())
    assert u.counts["lanes.pieces"] == _sub8x8(blocks, grid, sch)[0]
    assert (u.counts["lanes.pieces"] > 0) == (fmt == "420")
