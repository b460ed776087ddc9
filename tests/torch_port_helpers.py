"""Shared helpers of the tests/test_torch_*.py files: the committed
streams of av1dec_tpu_torch/testdata and their parse by either package,
seeded MC lanes, and the g++ build and run of a `csrc/` kernel against
the CPU shim `tests/cuda_cpu_shim.h`."""
import json
import os
import shutil
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(_ROOT, "av1dec_tpu_torch", "testdata")
BIG = ("bench_1080p_intra", "bench_1080p_intra_lf", "bench_1080p_intra_sres",
       "bench_1080p_inter", "bench_1080p_host", "bench_1080p_host_cq40",
       "bench_1080p_compound")


def manifest():
    with open(os.path.join(TESTDATA, "manifest.json")) as f:
        return json.load(f)


def small_streams():
    """Names of the committed small streams (all but the 1080p ones)."""
    return sorted(n for n in manifest() if n not in BIG)


def intra_streams():
    """The small all-intra streams."""
    man = manifest()
    return [n for n in small_streams() if not man[n].get("inter")]


def inter_streams():
    """The small streams with inter frames, all on the device path."""
    man = manifest()
    return [n for n in small_streams()
            if man[n].get("inter") and not man[n].get("host")]


def host_streams():
    """The small streams of the host pixel path, or with film grain
    (`"host"` in the manifest, with each coded frame's recon path)."""
    man = manifest()
    return [n for n in small_streams() if man[n].get("host")]


def stream_path(name):
    return os.path.join(TESTDATA, name + ".ivf")


def tus(name):
    from av1dec_tpu_torch.container import read_ivf
    return [d for _, d in read_ivf(stream_path(name))]


def parse(name, pkg):
    """[(seq, hdr, plans)] of every coded frame of a stream, parsed by
    the JAX package's native front end (pkg "jax") or the port's
    ("torch")."""
    if pkg == "jax":
        from av1dec_tpu.bindings import NativeParser
    else:
        from av1dec_tpu_torch.bindings import NativeParser
    p = NativeParser()
    out = []
    for tu in tus(name):
        for hdr, plans in p.parse_tu(tu, with_plans=True):
            if plans is not None:
                out.append((p.seq, hdr, plans))
    p.close()
    return out


_CAPTURED = {}


def decode_capture(name):
    """Decode a committed stream with the port's Decoder on the CPU, once
    a stream and process.  Returns (display MD5s, Decoder.stats, the
    DeviceRecon of every coded frame, in coding order), new lists of the
    memoised decode's objects, which the callers read and do not
    change."""
    if name not in _CAPTURED:
        _CAPTURED[name] = _decode_capture(name)
    return tuple(list(v) for v in _CAPTURED[name])


def _decode_capture(name):
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.config import DecoderConfig
    seen = []

    class Keep(api.DeviceRecon):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    real = api.DeviceRecon
    api.DeviceRecon = Keep
    try:
        dec = api.Decoder(DecoderConfig(apply_grain=False), device="cpu")
        md5s = []
        for tu in tus(name):
            md5s += [f.display_md5() for f in dec.decode(tu)]
        dec.close()
    finally:
        api.DeviceRecon = real
    return md5s, dec.stats, seen


def jax_refs(refs):
    """A DeviceRecon's `refs` for the JAX package: device planes as numpy."""
    if refs is None:
        return None
    return {r: dict(e, dev_planes=None if e["dev_planes"] is None else
                    [p.numpy() for p in e["dev_planes"]])
            for r, e in refs.items()}


# (forward, backward) distance weights of distance-weighted compound
QUANT_DIST_LOOKUP = [(9, 7), (11, 5), (12, 4), (13, 3)]
# seeded_mc_lanes' arguments for reference pieces larger than a window of
# T = 128 (135 x 135), of odd widths, so that rows start at every offset
# of a 16-byte chunk, and 8 lanes a bucket of T > 32
LARGE_PIECES = {"shapes": ((300, 333), (150, 177)), "big_lanes": 8}


def seeded_mc_lanes(bd, rng, shapes=((40, 56), (23, 31)), big_lanes=4):
    """(frame0, ref pieces, lanes) covering every MC bucket, both lists,
    both compound kinds, the four clamp corners and all filter banks;
    the lanes write disjoint pixels of frame0.  `shapes`: the (h, w) of
    the two reference pieces; the default's are smaller than most
    windows, so most rows need a clamp, pieces larger than 128 + 7 put
    most windows inside them.  Buckets of T <= 32 have 8 lanes, the
    others `big_lanes` (4 or more); lanes 0-3 start past the corners."""
    from av1dec_tpu_torch.ops.kernels.mc import MC_FIELDS, _MF
    from av1dec_tpu_torch.pipeline.device_inter import MC_BUCKETS
    dt = np.uint8 if bd == 8 else np.uint16
    pieces = [rng.integers(0, 1 << bd, s).astype(dt) for s in shapes]
    rbs = [0, shapes[0][0] * shapes[0][1]]
    post = 14 - (5 if bd == 12 else 3) - 7
    lanes, base = {}, 0
    for T in MC_BUCKETS:
        for comp in (0, 1):
            N = 8 if T <= 32 else big_lanes
            rows = np.zeros((N, len(MC_FIELDS)), np.int64)
            stride = 4 * T
            for i in range(N):
                r = rows[i]
                r[_MF["x"]], r[_MF["y"]] = (i % 4) * T, (i // 4) * T
                r[_MF["base"]], r[_MF["stride"]] = base, stride
                r[_MF["w"]], r[_MF["h"]] = rng.integers(1, T + 1, 2)
                for s in "01"[:1 + comp]:
                    k = int(rng.integers(2))
                    ph, pw = shapes[k]
                    lx = pw - 1 - int(rng.integers(3))
                    ly = ph - 1 - int(rng.integers(3))
                    # lanes 0-3 start past the four corners, the rest
                    # anywhere from left of the piece to right of it
                    cx, cy = [(-T - 10, -T - 10), (lx + 5, -3),
                              (-3, ly + 5), (lx + 5, ly + 5)][i] \
                        if i < 4 else rng.integers(-T - 12, [lx + 12,
                                                             ly + 12])
                    r[_MF["rb" + s]], r[_MF["rs" + s]] = rbs[k], pw
                    r[_MF["lx" + s]], r[_MF["ly" + s]] = lx, ly
                    r[_MF["cx" + s]], r[_MF["cy" + s]] = cx, cy
                    r[_MF["hf" + s]] = (i * 16 + rng.integers(16)) % 96
                    r[_MF["vf" + s]] = ((i + 3) * 16 +
                                        rng.integers(16)) % 96
                if comp and i % 2:               # distance-weighted
                    fwd, bck = QUANT_DIST_LOOKUP[int(rng.integers(4))]
                    if rng.integers(2):
                        fwd, bck = bck, fwd
                    r[_MF["w0"]], r[_MF["w1"]] = fwd, bck
                    r[_MF["bshift"]] = post + 4
                elif comp:                       # average
                    r[_MF["w0"]] = r[_MF["w1"]] = 1
                    r[_MF["bshift"]] = post + 1
            lanes[(T, comp)] = rows
            base += (N // 4 + 1) * T * stride
    frame0 = rng.integers(-5, 1 << bd, base).astype(np.int32)
    return frame0, pieces, lanes


def mc_lane_pixels(lanes):
    """Flat destination index of every pixel every MC lane writes, from a
    lane dict {(T, comp): [N, F] rows} (host arrays or tensors)."""
    from av1dec_tpu_torch.ops.kernels.mc import _MF
    out = [np.zeros(0, np.int64)]
    for rows in lanes.values():
        rows = rows.cpu().numpy() if hasattr(rows, "cpu") else rows
        for r in np.asarray(rows, np.int64):
            i, j = np.mgrid[:r[_MF["h"]], :r[_MF["w"]]]
            out.append((r[_MF["base"]] + (r[_MF["y"]] + i) * r[_MF["stride"]]
                        + r[_MF["x"]] + j).reshape(-1))
    return np.concatenate(out)


def shim_build(d, source, entry=None):
    """The g++ build of `av1dec_tpu_torch/csrc/<source>.cu` against the
    CPU shim with its main, in directory `d` (a pathlib.Path), calling
    the C function `entry` (default: the scan's entries).  Returns the
    executable, or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    os.makedirs(d / "cuda", exist_ok=True)
    shim = os.path.join(_ROOT, "tests", "cuda_cpu_shim.h")
    for name in ("cuda_runtime.h", "cuda_pipeline.h",
                 os.path.join("cuda", "atomic")):
        (d / name).write_text(f'#include "{shim}"\n')
    cu = os.path.join(_ROOT, "av1dec_tpu_torch", "csrc", source + ".cu")
    (d / "main.cc").write_text(f'#include "{cu}"\n')
    exe = str(d / f"{source}_shim")
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread",
                    "-DCUDA_CPU_SHIM_MAIN"] +
                   ([f"-DCUDA_CPU_SHIM_ENTRY={entry}"] if entry else []) +
                   ["-I", str(d), "-o", exe, str(d / "main.cc")],
                   check=True, capture_output=True, timeout=300)
    return exe


def shim_run(exe, d, params, count, shared, entry="run", resident=0):
    """Run the shim's main on a kernel's parameter list (tensors where it
    takes a pointer, (tensor, byte offset) for a pointer that far into a
    tensor, ints) in directory `d`: each tensor goes to a file, the
    tensors at the indices `shared` are read back after the launch.
    `count` is the entry's int argument; `resident` 0 runs the blocks
    one after another.  Returns (return code, {index: bytes}, stderr)."""
    import torch
    lines = []
    for k, v in enumerate(params):
        v, offset = v if isinstance(v, tuple) else (v, 0)
        if torch.is_tensor(v):
            (d / f"p{k}").write_bytes(v.contiguous().cpu().numpy().tobytes())
            lines.append(f"o p{k} {int(k in shared)} {offset}" if offset
                         else f"p p{k} {int(k in shared)}")
        else:
            lines.append(f"i {int(v)}")
    (d / "params.txt").write_text("\n".join(lines) + "\n")
    r = subprocess.run([exe, str(d), entry, str(resident), str(count)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        return r.returncode, None, r.stderr
    return 0, {k: (d / f"p{k}.out").read_bytes() for k in shared}, r.stderr


# (subx, suby) of each chroma format; None is mono
FORMATS = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "mono": None}
DEBLOCK_LENGTHS = (0, 4, 6, 8, 14)


def plane_dims(H, W, fmt):
    """[(h, w)] of a frame's planes: luma H x W and its chroma in `fmt`."""
    sub = FORMATS[fmt]
    if sub is None:
        return [(H, W)]
    sx, sy = sub
    return [(H, W)] + [((H + sy) >> sy, (W + sx) >> sx)] * 2


def smooth_plane(rng, H, W, bd, noise=3):
    """Gentle gradients + a little noise, so most deblock masks pass."""
    yy, xx = np.mgrid[:H, :W]
    base = (1 << (bd - 1)) + ((xx // 8 + yy // 8) % 3) * (6 << (bd - 8))
    return np.clip(base + rng.integers(-noise, noise + 1, (H, W)),
                   0, (1 << bd) - 1).astype(np.int32)


def tx_lengths(rng, n4, k4, chroma):
    """[n4, k4] int32 filter lengths of one direction's edges that follow
    the spec's transform-size rule [SPEC §7.14.2-3], as a stream's maps
    do: each line of 4x4 cells is cut into transform blocks of seeded
    sizes 4 to 64 (chroma 32), each starting at a multiple of its size;
    the edge between two blocks has the length of the smaller, 4 for 4,
    8 for 8 and 14 for 16 or more (chroma: 4, then 6); edges inside a
    block and the plane's first edge have length 0.  So no edge reads or
    writes a pixel another edge of the pass writes."""
    sizes = (1, 2, 4, 8, 16)[:4 if chroma else 5]   # in cells
    length = {1: 4, 2: 6 if chroma else 8}
    flen = np.zeros((n4, k4), np.int32)
    for r in range(n4):
        x, prev = 0, None
        while x < k4:
            s = int(rng.choice([c for c in sizes if x % c == 0]))
            if prev is not None:
                flen[r, x] = length.get(min(prev, s), 6 if chroma else 14)
            x, prev = x + s, s
    return flen


def seeded_deblock(rng, H, W, fmt, bd, maps="fit"):
    """A frame's planes and per-plane deblock maps, seeded.  Returns
    (bases, planes, maps): `planes[i]` is the [h, w] top-left view of the
    wider int32 buffer `bases[i]` (a row stride past the width, as the
    scan's frame buffer has); each 8x8 block has its own noise, from none
    to far past the flat and filter thresholds, so every filter and its
    masks run.  `maps[i]` = ((flen_v, lvl_v), (flen_h, lvl_h)), int32,
    level 0-63 anywhere.  The lengths of "tx" maps follow the transform
    sizes of a stream (`tx_lengths`: each edge writes only its own
    pixels); those of the other kinds are from DEBLOCK_LENGTHS anywhere,
    and some cell rows all 14, whose wide filters write each other's
    pixels (the order of the writers decides); "fit" and "tx" maps cover
    the plane's 4x4 cells, "small" ones one or two cells fewer, and
    "large" ones more, each way."""
    bases, planes, out = [], [], []
    for h, w in plane_dims(H, W, fmt):
        amp = rng.choice([0, 0, 0, 1, 2, 4, 12, 40],
                         (-(-h // 8), -(-w // 8)))
        amp = np.kron(amp, np.ones((8, 8), np.int64))[:h, :w] << (bd - 8)
        noise = np.round(rng.uniform(-1, 1, (h, w)) * amp).astype(np.int64)
        base = np.zeros((h + 3, w + 5), np.int32)
        base[:h, :w] = np.clip(smooth_plane(rng, h, w, bd, 0) + noise, 0,
                               (1 << bd) - 1)
        bases.append(base)
        planes.append(base[:h, :w])
        d = {"fit": 0, "tx": 0, "small": -int(rng.integers(1, 3)),
             "large": int(rng.integers(1, 3))}[maps]

        def cell(n4, k4):
            n4, k4 = max(1, n4 + d), max(1, k4 + d)
            if maps == "tx":
                flen = tx_lengths(rng, n4, k4, len(bases) > 1)
            else:
                # a quarter of the cell rows all 14: wide filters side by
                # side
                flen = rng.choice(DEBLOCK_LENGTHS, (n4, k4)).astype(np.int32)
                flen[rng.random(n4) < 0.25] = 14
            return flen, rng.integers(0, 64, (n4, k4)).astype(np.int32)
        out.append((cell(-(-h // 4), -(-w // 4)),
                    cell(-(-w // 4), -(-h // 4))))
    return bases, planes, out


def seeded_wiener_args(rng, W, H, sizes, plane, on=0.8):
    """`DeviceRecon._lr_wiener_args` of plane `plane` of a W x H 4:2:0
    frame whose planes have restoration units of `sizes`, each unit
    Wiener (probability `on`) or off, with seeded taps.  Returns (args,
    the header and plans that give them) (numpy)."""
    import types

    from av1dec_tpu_torch.ops.spec import lr as L
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    sub = 1 if plane else 0
    pw, ph = (W + sub) >> sub, (H + sub) >> sub
    frt = [0, 0, 0]
    frt[plane] = L.RESTORE_WIENER
    hdr = {"lr": {"frame_restoration_type": frt,
                  "loop_restoration_size": sizes},
           "upscaled_width": W, "frame_width": W, "frame_height": H}
    recs = []
    for ur in range(L._count_units(sizes[plane], ph)):
        for uc in range(L._count_units(sizes[plane], pw)):
            kind = L.RESTORE_WIENER if rng.random() < on else \
                L.RESTORE_NONE
            taps = rng.integers(-5, 10, 6)
            recs.append([plane, ur, uc, kind, *taps.tolist(), 0, 0, 0])
    plans = types.SimpleNamespace(lr=np.asarray(recs, np.int64))
    sch = types.SimpleNamespace(num_planes=3, sub_x=1, sub_y=1,
                                valid_dims=[(H, W), (ph, pw), (ph, pw)])
    args = DeviceRecon._lr_wiener_args(
        types.SimpleNamespace(hdr=hdr, sch=sch, plans=plans))[plane]
    return args, hdr, plans


def cut_wiener_args(args, rows, cols):
    """Wiener arguments of the rows and columns (slices) of a plane, as
    arguments of that cut plane: source rows shifted into it and clamped
    to it."""
    uy, ux, tv, th, act, vr, inside = args
    n = rows.stop - rows.start
    return (uy[rows], ux[cols], tv, th, act,
            np.clip(vr[:, rows] - rows.start, 0, n - 1).astype(np.int32),
            inside[:, rows])


def superres_case(rng, W, H, denom, fmt, bd):
    """Planes of a frame downscaled from width W by superres denominator
    `denom` [SPEC §7.16] in `fmt`, seeded, and the per-plane (cols, taps)
    of `DeviceRecon._superres_args`' arithmetic (numpy)."""
    import types

    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    fw = (W * 8 + denom // 2) // denom
    sub = FORMATS[fmt] or (0, 0)
    dims = plane_dims(H, fw, fmt)
    sch = types.SimpleNamespace(num_planes=len(dims), sub_x=sub[0],
                                sub_y=sub[1], valid_dims=dims)
    args = DeviceRecon._superres_args(types.SimpleNamespace(
        hdr={"frame_width": fw, "upscaled_width": W}, sch=sch))
    planes = [rng.integers(0, 1 << bd, d).astype(np.int32) for d in dims]
    return planes, args
