"""The postfilter kernels `csrc/deblock.cu`, `csrc/wiener.cu` and
`csrc/superres.cu` (one launch a frame each), compiled with g++ against
the CPU shim `tests/cuda_cpu_shim.h` and run on the host: the exact
sources, their blocks one after another and their threads as fibers of
one OS thread, or (the cross-tile cases) each block in a process of its
own.

- Deblock (a block a 64x64 tile, both passes in shared memory): byte-equal
  to `_deblock_plain` on seeded frames in the 4 formats at 8, 10 and 12
  bits with sharpness 0 and 5, odd widths and heights, maps with every
  length (0, 4, 6, 8, 14) beside every other, as large as the plane's
  cells, smaller and larger, and maps whose lengths follow the transform
  sizes, as a stream's do; the planes are read in place from wider
  buffers through their row stride.  On planes of several tiles cut by
  the planes' edges (4:2:0 chroma of 2x2 tiles), with wide filters on
  both sides of the tile boundaries, whose writes cross them.  And on
  the maps of every frame with deblocking of the `odd`, `tiles`, `mono`,
  `grain10` (10 bits), `qm_444` (4:4:4) and `sres_lr` streams.
- Wiener (a block a 32x64 tile, its keys' filtered rows in shared
  memory): byte-equal to `_wiener_plain` on seeded units at a 1080p
  frame's unit-row and stripe geometry, cut to the rows and columns
  around a unit-row, unit-column and stripe boundary (8, 10, 12 bits),
  and to cuts several tiles high and wide whose tiles straddle those
  boundaries (more than kTileH + 6 keys a tile); on arguments whose
  tiles have up to 7 x kTileH keys (several chunks of them); and on the
  arguments of the `lr` and `sres_lr` streams, every plane in one launch.
- Superres: byte-equal to `_superres_plain` on seeded planes upscaled at
  denominators 9 and 16 (`_superres_args`' arithmetic) in 4:2:0, 4:4:4
  and mono, the final and pre-CDEF planes in one launch, and on the
  tables of the `sres` and `sres_lr` streams.
- The sources' constants (parameters, planes a launch, the tiles and the
  Wiener chunk these cases are cut for) and C entries are the Python
  side's.

Skips when g++ is missing (decided inside the tests).
"""
import re

import numpy as np
import pytest
import torch

from av1dec_tpu_torch.ops.kernels import deblock, lr, superres
from torch_port_helpers import (_ROOT, FORMATS, cut_wiener_args, parse,
                                seeded_deblock, seeded_wiener_args,
                                shim_build, shim_run, smooth_plane,
                                superres_case)

ENTRIES = {"deblock": "deblock_frame", "wiener": "wiener_frame",
           "superres": "superres_frame"}


@pytest.fixture(scope="module")
def shims(tmp_path_factory):
    out = {}
    for src, entry in ENTRIES.items():
        exe = shim_build(tmp_path_factory.mktemp(src), src, entry)
        if exe is None:
            pytest.skip("needs g++ to build the CPU shim")
        out[src] = exe
    return out


def _run(exe, d, params, count, outs, resident=0):
    """The shim's launch on a parameter list whose tensors may be views
    into a wider buffer (passed as that buffer and the view's byte
    offset in it); returns the
    output tensors `outs`, read back, as arrays.  `resident` 0 runs the
    blocks one after another (their threads as fibers), above 0 each
    block in a process of its own, all at once."""
    args, read = [], {}
    for k, v in enumerate(params):
        if torch.is_tensor(v):
            for j, o in enumerate(outs):
                if v is o:
                    read[k] = j
            if v._base is not None:  # a pointer into its buffer
                offset = v.data_ptr() - v._base.data_ptr()
                v = (v._base, offset) if offset else v._base
        args.append(v)
    rc, got, err = shim_run(exe, d, args, count, set(read),
                            resident=resident)
    assert rc == 0, err
    res = [None] * len(outs)
    for k, j in read.items():
        res[j] = np.frombuffer(got[k], np.int32).reshape(outs[j].shape)
    return res


def _shim_deblock(exe, d, planes, maps, sharp, bd, resident=0):
    """Both passes of `planes` (tensors, read through their row stride)
    through the shim, one launch, into new planes."""
    dst = [torch.zeros(p.shape, dtype=torch.int32) for p in planes]
    params = deblock._params(sharp, bd, planes, dst, maps)
    return [torch.as_tensor(a.copy())
            for a in _run(exe, d, params, len(planes), dst, resident)]


def _check_deblock(exe, d, planes, maps, sharp, bd, resident=0):
    """The shim's deblock byte-equal to `_deblock_plain`; returns the
    pixels the filters changed."""
    tmaps = tuple(tuple(tuple(torch.as_tensor(np.asarray(m, np.int32))
                              for m in pair) for pair in pm) for pm in maps)
    want = deblock._deblock_plain(tuple(planes), tmaps, sharp, bd)
    got = _shim_deblock(exe, d, planes, tmaps, sharp, bd, resident)
    changed = 0
    for g, w, p in zip(got, want, planes):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        changed += int((g != p).sum())
    return changed


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_shim_deblock_matches_plain_on_seeded_frames(fmt, bd, shims,
                                                     tmp_path):
    rng = np.random.default_rng(16 * list(FORMATS).index(fmt) + bd)
    kind = ("fit", "small", "large")[bd // 2 - 4]
    for sharp in (0, 5):
        bases, planes, maps = seeded_deblock(rng, 22, 38, fmt, bd, kind)
        views = [torch.as_tensor(b)[:p.shape[0], :p.shape[1]]
                 for b, p in zip(bases, planes)]
        assert views[0].stride(0) > views[0].shape[1]
        assert _check_deblock(shims["deblock"], tmp_path, views, maps,
                              sharp, bd) > 0


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_shim_deblock_matches_plain_on_transform_size_maps(fmt, shims,
                                                           tmp_path):
    rng = np.random.default_rng(70 + list(FORMATS).index(fmt))
    for bd, sharp in ((8, 0), (12, 7)):
        bases, planes, maps = seeded_deblock(rng, 37, 70, fmt, bd, "tx")
        views = [torch.as_tensor(b)[:p.shape[0], :p.shape[1]]
                 for b, p in zip(bases, planes)]
        assert _check_deblock(shims["deblock"], tmp_path, views, maps,
                              sharp, bd) > 0


@pytest.mark.parametrize("sharp", [0, 3, 7])
def test_shim_deblock_matches_plain_at_odd_sizes(sharp, shims, tmp_path):
    rng = np.random.default_rng(30 + sharp)
    changed = 0
    for H, W in ((13, 21), (5, 7), (34, 9)):
        _, planes, maps = seeded_deblock(rng, H, W, "420", 8)
        changed += _check_deblock(
            shims["deblock"], tmp_path,
            [torch.as_tensor(p.copy()) for p in planes], maps, sharp, 8)
    assert changed > 0


# output tile of a block of csrc/deblock.cu (kTileH = kTileW)
DEBLOCK_TILE = 64


@pytest.mark.parametrize("resident", [0, 2])
@pytest.mark.parametrize("kind", ["fit", "tx"])
def test_shim_deblock_matches_plain_across_tiles(kind, resident, shims,
                                                 tmp_path):
    """Planes of several tiles, cut by the planes' edges (luma 150x205:
    3x4 tiles, the last row and column part-filled; 4:2:0 chroma 75x103:
    2x2), read through a row stride.  On stress maps whose edges 14-18
    in both directions (pixels 56-72, across the tile boundary at 64)
    all have length 14, so that wide filters on both sides of a boundary
    write each other's pixels and the halo's, and on transform-size
    maps.  The pixels within 24 of those boundaries vary by at most the
    flat threshold (2 either way of 512 at 10 bits), so that the wide
    filters there run, also those of the edge just before a tile.  With
    the blocks one after another and each in a process of its own."""
    rng = np.random.default_rng(90 + 2 * resident + (kind == "tx"))
    bases, planes, maps = seeded_deblock(rng, 150, 205, "420", 10, kind)
    assert planes[0].shape[1] > 3 * DEBLOCK_TILE and \
        planes[1].shape[0] > DEBLOCK_TILE
    near = slice(DEBLOCK_TILE - 24, DEBLOCK_TILE + 24)
    for b in bases:
        for region in ((near, slice(None)), (slice(None), near)):
            b[region] = 512 + rng.integers(-2, 3, b[region].shape)
    if kind == "fit":
        for (fv, _), (fh, _) in maps:
            fv[:, 14:19] = fh[:, 14:19] = 14
    views = [torch.as_tensor(b)[:p.shape[0], :p.shape[1]]
             for b, p in zip(bases, planes)]
    assert _check_deblock(shims["deblock"], tmp_path, views, maps, 3, 10,
                          resident) > 0


@pytest.mark.parametrize("name", ["odd", "tiles", "mono", "grain10",
                                  "qm_444", "sres_lr"])
def test_shim_deblock_matches_plain_on_stream_maps(name, shims, tmp_path,
                                                   native_lib):
    from av1dec_tpu_torch.ops.spec.deblock import build_deblock_maps
    from av1dec_tpu_torch.pipeline.wavefront import Schedule
    rng = np.random.default_rng(3)
    n = 0
    for seq, hdr, plans in parse(name, "torch"):
        sch = Schedule(seq, hdr, plans)
        maps = build_deblock_maps(seq, hdr, plans, sch.num_planes)
        if maps is None:
            continue
        planes = [torch.as_tensor(smooth_plane(rng, h, w, sch.bd, 6))
                  for h, w in sch.valid_dims]
        _check_deblock(shims["deblock"], tmp_path, planes, maps,
                       int(hdr["lf"]["sharpness"]), sch.bd)
        n += 1
    assert n >= 1


def _check_wiener(exe, d, cdef_p, pre_p, args, bd, resident=0):
    """The shim's Wiener pass over the planes with arguments, one launch,
    byte-equal to `_wiener_plain`; returns the pixels it changed."""
    targs = [None if a is None else tuple(torch.as_tensor(x) for x in a)
             for a in args]
    want = lr._wiener_plain(cdef_p, pre_p, targs, bd)
    todo = [p for p, a in enumerate(targs) if a is not None]
    outs = [torch.zeros(cdef_p[p].shape, dtype=torch.int32) for p in todo]
    got = _run(exe, d, lr._params(bd, [(cdef_p[p], pre_p[p], o, targs[p])
                                       for p, o in zip(todo, outs)]),
               len(todo), outs, resident)
    changed = 0
    for p, g in zip(todo, got):
        np.testing.assert_array_equal(g, want[p].numpy())
        changed += int((g != cdef_p[p].numpy()).sum())
    return changed


# (rows, columns) around a unit-row boundary that is also a stripe
# boundary (luma row 248 = 256 - 8; chroma row 124 = 128 - 4), and a
# unit-column boundary (luma 256, chroma 128)
CUTS = {0: (slice(232, 262), slice(236, 276)),
        1: (slice(110, 140), slice(112, 146))}


@pytest.mark.parametrize("plane", [0, 1, 2])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_shim_wiener_matches_plain_at_1080p_unit_rows(plane, bd, shims,
                                                      tmp_path):
    rng = np.random.default_rng(40 + plane + bd)
    args, _, _ = seeded_wiener_args(rng, 1920, 1080, [256, 128, 128], plane)
    rows, cols = CUTS[min(plane, 1)]
    cut = cut_wiener_args(args, rows, cols)
    assert len(set(cut[0])) == 2 and len(set(cut[1])) == 2
    h, w = rows.stop - rows.start, cols.stop - cols.start
    bases = [np.zeros((h, w + 3), np.int32) for _ in range(2)]
    for b in bases:
        b[:, :w] = smooth_plane(rng, h, w, bd, 40 << (bd - 8))
    cdef_p, pre_p = (torch.as_tensor(b)[:, :w] for b in bases)
    assert _check_wiener(shims["wiener"], tmp_path, [cdef_p], [pre_p],
                         [cut], bd) > 0


# output tile of a block of csrc/wiener.cu (kTileH x kTileW), and the
# keys whose rows it holds at once (kChunk)
WIENER_TILE = (32, 64)
WIENER_CHUNK = 64


def _tile_keys(args):
    """The most distinct (source row, plane, unit row) keys that a tile
    of the kernel (WIENER_TILE[0] rows) has on these arguments."""
    uy, _, _, _, _, vr, inside = (np.asarray(a) for a in args)
    most = 0
    for y0 in range(0, len(uy), WIENER_TILE[0]):
        ys = slice(y0, y0 + WIENER_TILE[0])
        most = max(most, len(set(zip(
            vr[:, ys].ravel(), inside[:, ys].ravel(),
            np.broadcast_to(uy[ys], vr[:, ys].shape).ravel()))))
    return most


def _strided_planes(rng, h, w, bd, noise):
    """Seeded post- and pre-CDEF planes [h, w], views of wider buffers."""
    bases = [np.zeros((h, w + 3), np.int32) for _ in range(2)]
    for b in bases:
        b[:, :w] = smooth_plane(rng, h, w, bd, noise)
    return [torch.as_tensor(b)[:, :w] for b in bases]


@pytest.mark.parametrize("resident", [0, 2])
@pytest.mark.parametrize("plane", [0, 1])
def test_shim_wiener_matches_plain_across_tiles(plane, resident, shims,
                                                tmp_path):
    """Cuts of a 1080p 4:2:0 frame's plane several tiles high and wide,
    whose tiles straddle stripe boundaries, a unit-row boundary and a
    unit-column boundary (luma rows 203-332 across 248 and 312, columns
    190-329 across 256; chroma rows 70-199 across 92, 124, 156 and 188,
    columns 95-164 across 128), so that a tile has more than kTileH + 6
    keys.
    With the blocks one after another and each in a process of its
    own."""
    rng = np.random.default_rng(60 + plane + resident)
    args, _, _ = seeded_wiener_args(rng, 1920, 1080, [256, 128, 128], plane)
    rows, cols = {0: (slice(203, 333), slice(190, 330)),
                  1: (slice(70, 200), slice(95, 165))}[plane]
    cut = cut_wiener_args(args, rows, cols)
    h, w = rows.stop - rows.start, cols.stop - cols.start
    assert h > 3 * WIENER_TILE[0] and w > WIENER_TILE[1]
    assert len(set(cut[0])) == 2 and len(set(cut[1])) == 2
    assert _tile_keys(cut) > WIENER_TILE[0] + 6
    cdef_p, pre_p = _strided_planes(rng, h, w, 10, 160)
    assert _check_wiener(shims["wiener"], tmp_path, [cdef_p], [pre_p],
                         [cut], 10, resident) > 0


@pytest.mark.parametrize("resident", [0, 2])
def test_shim_wiener_matches_plain_on_any_rows(resident, shims, tmp_path):
    """Arguments the wrapper takes but no stream gives: each (tap, row)
    reads a seeded source row from a seeded plane, and each row and
    column has a seeded unit, so a tile has up to 7 x kTileH distinct
    keys, more than three chunks of them; 12 bits."""
    rng = np.random.default_rng(77 + resident)
    H, W, UR, UC = 150, 90, 4, 3

    def taps():
        t = rng.integers(-5, 10, (UR, UC, 3))
        return np.concatenate([t, 128 - 2 * t.sum(2, keepdims=True),
                               t[:, :, ::-1]], 2).astype(np.int32)
    args = (rng.integers(0, UR, H).astype(np.int32),
            rng.integers(0, UC, W).astype(np.int32), taps(), taps(),
            (rng.random((UR, UC)) < 0.8).astype(np.int32),
            rng.integers(0, H, (7, H)).astype(np.int32),
            rng.random((7, H)) < 0.5)
    assert _tile_keys(args) > 3 * WIENER_CHUNK
    cdef_p, pre_p = _strided_planes(rng, H, W, 12, 600)
    assert _check_wiener(shims["wiener"], tmp_path, [cdef_p], [pre_p],
                         [args], 12, resident) > 0


@pytest.mark.parametrize("name", ["lr", "sres_lr"])
def test_shim_wiener_matches_plain_on_stream_args(name, shims, tmp_path,
                                                  native_lib):
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    rng = np.random.default_rng(4)
    n = 0
    for seq, hdr, plans in parse(name, "torch"):
        args = DeviceRecon(seq, hdr, plans)._lr_wiener_args()
        if args is None:
            continue
        bd = seq["bit_depth"]
        shapes = [(a[0].shape[0], a[1].shape[0]) if a is not None else
                  (8, 8) for a in args]
        cdef_p = [torch.as_tensor(smooth_plane(rng, h, w, bd, 20))
                  for h, w in shapes]
        pre_p = [torch.as_tensor(smooth_plane(rng, h, w, bd, 20))
                 for h, w in shapes]
        assert _check_wiener(shims["wiener"], tmp_path, cdef_p, pre_p, args,
                             bd) > 0
        n += 1
    assert n >= 1


def _check_superres(exe, d, planes, args, bd, resident=0):
    """The shim's upscale of `planes` (tensors) with their tables, one
    launch, byte-equal to `_superres_plain`."""
    targs = [tuple(torch.as_tensor(x) for x in a) for a in args]
    want = superres._superres_plain(planes, targs, bd)
    outs = [torch.zeros(w.shape, dtype=torch.int32) for w in want]
    got = _run(exe, d, superres._params(bd, planes, targs, outs),
               len(planes), outs, resident)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("fmt", ["420", "444", "mono"])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_shim_superres_matches_plain_on_seeded_planes(fmt, bd, shims,
                                                      tmp_path):
    rng = np.random.default_rng(bd * 7 + len(fmt))
    for denom in (9, 16):
        planes, args = superres_case(rng, 138, 9, denom, fmt, bd)
        # the final planes, then the pre-CDEF planes (views of wider
        # buffers), in one launch
        pre = []
        for p in planes:
            b = np.zeros((p.shape[0], p.shape[1] + 5), np.int32)
            b[:, :p.shape[1]] = rng.integers(0, 1 << bd, p.shape)
            pre.append(torch.as_tensor(b)[:, :p.shape[1]])
        _check_superres(shims["superres"], tmp_path,
                        [torch.as_tensor(p) for p in planes] + pre,
                        list(args) * 2, bd)


@pytest.mark.parametrize("name", ["sres", "sres_lr"])
def test_shim_superres_matches_plain_on_stream_tables(name, shims, tmp_path,
                                                      native_lib):
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    rng = np.random.default_rng(5)
    n = 0
    for seq, hdr, plans in parse(name, "torch"):
        if not hdr.get("use_superres"):
            continue
        dr = DeviceRecon(seq, hdr, plans)
        bd = seq["bit_depth"]
        planes = [torch.as_tensor(rng.integers(0, 1 << bd, (h, w))
                                  .astype(np.int32))
                  for h, w in dr.sch.valid_dims]
        _check_superres(shims["superres"], tmp_path, planes,
                        dr._superres_args(), bd)
        n += 1
    assert n >= 1


# a block of csrc/superres.cu: kBandH output rows x kStripW output
# columns; the words of its staged row (kPitch), which the block's
# source span (the least to the greatest column of its tables) and the
# span's offset in its first 16-byte chunk (up to 3 words) must fit
SUPERRES_TILE = (32, 128)
SUPERRES_PITCH = 144


def _staged_blocks(args, planes):
    """Whether each strip of each plane (SUPERRES_TILE[1] output columns)
    stages its source span in shared memory (the span fits a staged
    row), from the tables clamped to the row as the kernel clamps them."""
    out = []
    for (cols, _), p in zip(args, planes):
        c = np.clip(np.asarray(cols), 0, p.shape[1] - 1)
        for x0 in range(0, len(c), SUPERRES_TILE[1]):
            strip = c[x0:x0 + SUPERRES_TILE[1]]
            out.append(int(strip.max() - strip.min()) + 1 + 3 <=
                       SUPERRES_PITCH)
    return out


def _sr_views(rng, shapes, bd, pad=0, offsets=None):
    """Seeded int32 planes of `shapes`, each a view into a buffer of its
    own: its rows w + pad apart, starting offsets[i] words in (the
    kernel then sees a base 4 * offsets[i] bytes past a 16-byte
    boundary)."""
    out = []
    for i, (h, w) in enumerate(shapes):
        off = offsets[i] if offsets else 0
        buf = torch.zeros(off + h * (w + pad) + 1, dtype=torch.int32)
        v = buf[off:off + h * (w + pad)].view(h, w + pad)[:, :w]
        v.copy_(torch.as_tensor(rng.integers(0, 1 << bd, (h, w))
                                .astype(np.int32)))
        out.append(v)
    return out


@pytest.mark.parametrize("denom", list(range(9, 17)))
def test_superres_tables_fit_the_staged_rows(denom):
    """For every upscaled width the host's tables can have (2 to 8192
    luma columns, a 4:2:0 frame's chroma too), each block's source span
    fits its staged rows, so no superres frame reads its rows through
    the cache."""
    rng = np.random.default_rng(160 + denom)
    widths = list(range(2, 700)) + [1280, 1920, 2560, 3840, 4096, 7680,
                                    8192] + \
        list(rng.integers(700, 8192, 40))
    for W in widths:
        planes, args = superres_case(rng, int(W), 2, denom, "420", 8)
        assert all(_staged_blocks(args, planes)), (W, denom)


@pytest.mark.parametrize("denom", list(range(9, 17)))
def test_shim_superres_matches_plain_at_every_denominator(denom, shims,
                                                          tmp_path):
    """Every superres denominator on a 4:2:0 frame 301 wide (chroma 151:
    odd) and 70 high, neither a multiple of the block's strip or band
    (the last strip and band part-filled); the final planes read through
    a row stride, the pre-CDEF planes at bases 4, 8 and 12 bytes past a
    16-byte boundary, 6 planes in one launch; 8, 10 or 12 bits.  Every
    block stages its source span."""
    bd = (8, 10, 12)[denom % 3]
    rng = np.random.default_rng(100 + denom)
    planes, args = superres_case(rng, 301, 70, denom, "420", bd)
    shapes = [p.shape for p in planes]
    assert args[1][0].shape[0] == 151
    final = _sr_views(rng, shapes, bd, pad=7)
    pre = _sr_views(rng, shapes, bd, offsets=[1, 2, 3])
    assert all(p.data_ptr() % 16 for p in pre)
    assert all(_staged_blocks(args, planes))
    _check_superres(shims["superres"], tmp_path, final + pre,
                    list(args) * 2, bd)


@pytest.mark.parametrize("resident", [0, 2])
@pytest.mark.parametrize("fmt,pre", [("mono", False), ("444", False),
                                     ("420", True)])
def test_shim_superres_matches_plain_across_blocks(fmt, pre, resident,
                                                   shims, tmp_path):
    """1, 3 and 6 planes in one launch (mono; 4:4:4; 4:2:0 with the
    pre-CDEF planes), each several blocks wide and high (luma 290 x 75
    from 193 columns at denominator 12: 3 strips, 3 bands, the last of
    each part-filled), read through a row stride (the pre-CDEF planes at
    a base 8 bytes past a 16-byte boundary); with the blocks one after
    another and each in a process of its own."""
    rng = np.random.default_rng(120 + 2 * resident + len(fmt))
    planes, args = superres_case(rng, 290, 75, 12, fmt, 10)
    shapes = [p.shape for p in planes]
    views = _sr_views(rng, shapes, 10, pad=3)
    if pre:
        views += _sr_views(rng, shapes, 10, offsets=[2] * len(shapes))
        args = list(args) * 2
    assert len(views) == {"mono": 1, "444": 3, "420": 6}[fmt]
    assert shapes[0][0] > 2 * SUPERRES_TILE[0] and \
        args[0][0].shape[0] > 2 * SUPERRES_TILE[1]
    _check_superres(shims["superres"], tmp_path, views, args, 10, resident)


@pytest.mark.parametrize("aligned", [True, False])
def test_shim_superres_matches_plain_on_any_tables(aligned, shims,
                                                   tmp_path):
    """Tables the host's arithmetic never builds: seeded columns anywhere
    in the source row and seeded taps, so that the blocks' spans do not
    fit a staged row and read the rows through the cache, beside a first
    strip whose columns are a superres table's (staged), in one launch;
    the tables 16-byte aligned (vector loads) or 4 bytes past (scalar
    loads)."""
    rng = np.random.default_rng(140 + aligned)
    shapes = [(45, 150), (23, 75)]
    planes = _sr_views(rng, shapes, 12, pad=2)
    args = []
    for h, w in shapes:
        dw = 2 * w - 7
        cols = rng.integers(0, w, (dw, 8))
        x = np.arange(SUPERRES_TILE[1])
        cols[:SUPERRES_TILE[1]] = np.clip(
            (x * w // dw)[:, None] + np.arange(8) - 3, 0, w - 1)
        taps = rng.integers(-30, 100, (dw, 8))
        tabs = []
        for tab in (cols, taps):
            buf = torch.zeros(tab.size + 1, dtype=torch.int32)
            t = buf[int(not aligned):][:tab.size].view(tab.shape)
            t.copy_(torch.as_tensor(tab.astype(np.int32)))
            tabs.append(t)
        assert (tabs[0].data_ptr() % 16 == 0) == aligned
        args.append(tuple(tabs))
    staged = _staged_blocks(args, planes)
    assert staged[0] and not all(staged)
    _check_superres(shims["superres"], tmp_path, planes, args, 12)


def _enum(src):
    body = re.search(r"enum Param : int \{(.*?)\};", src, re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


@pytest.mark.parametrize("name,mod", [("deblock", deblock), ("wiener", lr),
                                      ("superres", superres)])
def test_postfilter_constants_locked(name, mod):
    from av1dec_tpu_torch.ops.kernels import cuda_build
    with open(f"{_ROOT}/av1dec_tpu_torch/csrc/{name}.cu") as f:
        src = f.read()
    params = _enum(src)
    assert params.pop("kParams") == len(mod._PARAMS)
    # the per-plane parameters are arrays, named by their first entry
    assert params == {"P_" + n.upper(): i for i, n in enumerate(mod._PARAMS)
                      if not re.search(r"[1-9]$", n)}
    assert int(re.search(r"kMaxPlanes = (\d+);", src).group(1)) == \
        mod.MAX_PLANES
    fns, argtypes = cuda_build.KERNELS[name]
    assert fns == (ENTRIES[name],)
    # the tiles the shim cases cut their planes into
    tile = {"deblock": (DEBLOCK_TILE, DEBLOCK_TILE),
            "wiener": WIENER_TILE}.get(name)
    if tile:
        assert tuple(int(re.search(r"k%s = (\d+);" % k, src).group(1))
                     for k in ("TileH", "TileW")) == tile
    if name == "superres":
        assert tuple(int(re.search(r"k%s = (\d+);" % k, src).group(1))
                     for k in ("BandH", "StripW")) == SUPERRES_TILE
        assert re.search(r"kPitch = kStripW \+ (\d+);", src).group(1) == \
            str(SUPERRES_PITCH - SUPERRES_TILE[1])
    if name == "wiener":
        assert int(re.search(r"kChunk = (\d+);", src).group(1)) == \
            WIENER_CHUNK
    sig = re.search(r'extern "C" int %s\((.*?)\)' % ENTRIES[name], src,
                    re.S).group(1)
    assert len(sig.split(",")) == len(argtypes) == 3
