"""Generate the committed test streams of av1dec_tpu_torch.

Writes `av1dec_tpu_torch/testdata/`:

- `bench_1080p_intra.ivf`: the 1920x1080 8-frame all-intra stream, made
  exactly as `bench.py:ensure_stream` makes it (seed 5);
- `bench_1080p_intra_lf.ivf` (BIG_LF): the same content and seed at
  cq-level LF_CQ, where libaom picks a loop-filter level in every frame
  (at cq-level 40 it picks 0), so the device deblock runs at 1080p;
- `bench_1080p_intra_sres.ivf` (BIG_SRES): the same content and seed
  with superres at denominator SRES_DENOM in every frame (coded
  960 wide, upscaled to 1920), so the device superres runs at 1080p;
- `bench_1080p_inter.ivf`: the 1920x1080 low-delay stream (1 key frame,
  7 inter frames; OBMC, warped motion, masked compound, inter-intra and
  global motion off), made exactly as `bench.py:ensure_inter_stream`
  makes it (seed 17);
- `bench_1080p_host.ivf`: the same content and seed, HOST_FRAMES
  frames at cpu-used 3 and cq-level HOST_CQ with OBMC, warped and
  global motion and inter-intra on (HOST_TOOLS), so most inter frames
  take the host pixel path; `bench_1080p_host_cq40.ivf` (BIG_HOST40):
  the same at cq-level 40, whose key frame meets the reference's device
  Wiener fault;
- `bench_1080p_compound.ivf` (BIG_COMPOUND): the inter content with
  lag 8, alt-ref frames and distance-weighted compound on, at cpu-used
  COMPOUND_CPU, so most inter frames carry compound blocks;
- the inter streams of `tests/test_device_inter.py` (BATTERY), made by
  `tools/gen_inter_battery.py:gen_case` with its seeds, plus
  INTER_CASES: a low-delay 10-bit stream with the exotic inter tools
  off, COMPOUND_CASES: streams with compound blocks (average,
  distance-weighted and difference-weighted; `ra_bd10` at 10 bits,
  every frame on the device path), and HOST_CASES: the
  battery streams of `tests/test_inter_bitexact.py` that the reference
  takes partly on its host pixel path, or that carry film grain;
- `occlusion.ivf` (OCCLUSION_CASE): a disc moving over a moving
  checkerboard, with compound wedge blocks, 4x16 palette blocks and
  alt-ref groups;
- `gops.ivf`: the 12-frame stream of three keyframe-delimited GOPs
  that `tests/test_gop_parallel.py` makes (GOP_CASE), for the port's
  GOP-parallel decode;
- one small all-intra stream per `tests/conftest.py` SPEC_CASES entry,
  seeded with `zlib.crc32(name)` so the content is the same on every
  machine, plus EXTRA_CASES: `palette` (screen content with palette
  blocks), `cdef_mid` (deblock and CDEF at real strengths) and `lr_sgr`
  (self-guided restoration units);
- `manifest.json`: per stream, the per-frame MD5s of the libaom oracle
  decode: the coded planes (Y only for monochrome) at the displayed
  size, as uint8 or uint16 bytes (`av1dec_tpu_torch.api.display_md5`),
  the file's size, `"inter": true` for the streams with inter frames,
  and for HOST_CASES, PORT_CHECKED, `bench_1080p_host` and `gops`
  `"host": true` with `"paths"`, the reference's recon path ("device"
  or "host") of every coded frame.

A stream is kept only when the JAX reference (`av1dec_tpu.api.Decoder`
with the device path on, CPU backend) decodes it to the oracle's MD5s
with no compound block, and takes every frame on its device path unless
the stream is a HOST_CASES one, `bench_1080p_host` or `gops`.  The
PORT_CHECKED streams (compound frames, and the cq-40 Wiener rows, which
the reference decodes unlike libaom) are held instead to the port's
decode on the CPU, which must equal the oracle (every frame of
`bench_1080p_compound` on the device path).  The script reports the
streams it dropped.

    JAX_PLATFORMS=cpu python tools/gen_torch_testdata.py [--skip-1080p]
        [--only NAME ...]
"""
import argparse
import hashlib
import json
import os
import sys
import zlib

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))
sys.path.insert(0, os.path.join(_REPO, "tests"))

OUT = os.path.join(_REPO, "av1dec_tpu_torch", "testdata")
BIG = "bench_1080p_intra"
# BIG at cq-level LF_CQ: every frame has a loop-filter level
BIG_LF = "bench_1080p_intra_lf"
LF_CQ = 55
# BIG with superres (SUPERRES_FIXED) at denominator SRES_DENOM in every
# frame: the device superres runs at 1080p
BIG_SRES = "bench_1080p_intra_sres"
SRES_DENOM = 16
BIG_INTER = "bench_1080p_inter"
BIG_HOST = "bench_1080p_host"
HOST_FRAMES = 8  # frames of BIG_HOST: 1 key frame, then inter frames

# tests/test_device_inter.py: _SIMPLE, then _MIXED (whole on the device
# path)
BATTERY = ["neither", "mrf3", "aq0b", "t160x96", "w136",
           "lowdelay", "bframes", "interbd10"]
# tests/test_inter_bitexact.py streams that the reference takes partly
# on its host pixel path (OBMC, warp, scaled references, intra block
# copy), or whose output carries film grain
HOST_CASES = ["warp", "warponly", "obmc", "obmconly", "grain", "grain10",
              "scaledref", "scaledref2", "screen", "intermono", "qm_inter",
              "sres_inter"]
# the inter tools the device MC path does not take, off
_SIMPLE_TOOLS = [("enable-obmc", "0"), ("enable-warped-motion", "0"),
                 ("enable-masked-comp", "0"),
                 ("enable-interintra-comp", "0"),
                 ("enable-global-motion", "0")]
# gen_inter_battery.gen_case specs: 10-bit lanes on the device path
# even where a _MIXED stream falls back to the host
INTER_CASES = {
    "inter_bd10": dict(w=128, h=96, n=4, cpu=6, bd=10,
                       extra=_SIMPLE_TOOLS),
}
# gen_inter_battery.gen_case specs of streams with compound blocks (at
# cpu 3 the encoder picks none in this content): "c4" with
# distance-weighted compound, "c5" with average compound only, "masked"
# with masked compound on (at 192x128 the encoder picks
# difference-weighted blocks, whose frames take the host pixel path; it
# picks no compound wedge), and the inter-intra streams below.  The JAX
# reference and its native parser differ from libaom on compound and
# inter-intra frames (ROADMAP queue 3), so these streams are checked
# with the port's repaired copies instead (PORT_CHECKED), and their
# paths are the reference's rule applied to the port's parse.
COMPOUND_CASES = {
    name: dict(w=128, h=96, n=10, cpu=1, lag=8,
               extra=_SIMPLE_TOOLS + [("enable-dist-wtd-comp", dist),
                                      ("auto-alt-ref", "1")])
    for name, dist in (("c4", "1"), ("c5", "0"))
}
# a 10-bit random-access stream (lag 8, alt-ref frames, distance-
# weighted compound), whose every frame the device path takes
COMPOUND_CASES["ra_bd10"] = dict(
    w=256, h=144, n=12, cpu=1, lag=8, bd=10,
    extra=_SIMPLE_TOOLS + [("enable-dist-wtd-comp", "1"),
                           ("auto-alt-ref", "1")])
COMPOUND_CASES["masked"] = dict(
    w=192, h=128, n=12, cpu=1, lag=8,
    extra=[t for t in _SIMPLE_TOOLS if t[0] != "enable-masked-comp"] +
    [("enable-masked-comp", "1"), ("auto-alt-ref", "1")])
# inter-intra, whose masks the reference builds unlike libaom:
# "interintra" with libaom's default tools and masked and
# distance-weighted compound (a wedge inter-intra block, difference-
# weighted compound, OBMC), "interintra_smooth" with the wedge off
# (smooth inter-intra masks)
COMPOUND_CASES["interintra"] = dict(
    w=192, h=128, n=14, cpu=1, lag=10,
    extra=[("enable-interintra-comp", "1"), ("enable-masked-comp", "1"),
           ("auto-alt-ref", "1"), ("enable-dist-wtd-comp", "1")])
COMPOUND_CASES["interintra_smooth"] = dict(
    w=192, h=128, n=10, cpu=0,
    extra=[("enable-interintra-comp", "1"),
           ("enable-interintra-wedge", "0"), ("enable-masked-comp", "0"),
           ("enable-obmc", "0"), ("enable-warped-motion", "0")])

# a disc moving over a moving checkerboard (occlusions): at cpu-used 0
# with lag 16 and masked compound on, the encoder picks compound wedge
# blocks, palette blocks (4x16 among them), and alt-ref groups whose
# temporal motion field projects from future references
OCCLUSION_CASE = "occlusion"


def _encode_occlusion(path):
    import aomffi
    W, H, N = 192, 128, 16
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[:H, :W]
    bg = (((xx // 6) + (yy // 9)) % 2) * 120 + 60
    enc = aomffi.AomEncoder(
        W, H, cpu_used=0, kf_max_dist=9999, lag=16, bitrate_kbps=400,
        options=[("enable-masked-comp", "1"), ("auto-alt-ref", "1"),
                 ("enable-obmc", "0"), ("enable-warped-motion", "0")])
    pkts = []
    for t in range(N):
        y = np.roll(bg, 2 * t, axis=1).astype(np.int64)
        disc = (xx - (150 - 5 * t)) ** 2 + (yy - (64 + 2 * t)) ** 2 < 900
        y[disc] = (200 + 30 * np.sin(xx[disc] / 3.0)).astype(np.int64)
        y = np.clip(y + rng.integers(-4, 5, y.shape), 0, 255) \
            .astype(np.uint8)
        u = np.full((H // 2, W // 2), 128, np.uint8)
        v = np.full((H // 2, W // 2), 128, np.uint8)
        u[disc[::2, ::2]] = 90
        pkts += enc.encode(y, u, v, pts=t)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, W, H)


# tests/test_gop_parallel.py's stream: 128x96, key frames at TUs 0, 4
# and 8 (kf_max_dist 4), synthetic frames seeded with 9; libaom's
# default tools, so one inter frame takes the host pixel path (its
# manifest entry records the paths, as HOST_CASES')
GOP_CASE = "gops"


def _encode_gops(path):
    """The GOP stream exactly as tests/test_gop_parallel.py makes it."""
    import aomffi
    from conftest import _synth_frame
    rng = np.random.default_rng(9)
    enc = aomffi.AomEncoder(128, 96, cpu_used=9, kf_max_dist=4, lag=0,
                            bitrate_kbps=300)
    pkts = []
    for t in range(12):
        pkts += enc.encode(*_synth_frame(128, 96, t, rng), pts=t)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, 128, 96)


# extra case beside SPEC_CASES: few-colour screen content, so the scan
# sees palette lanes (aomenc only searches palette for screen content)
EXTRA_CASES = {
    "palette": dict(w=64, h=64, n=1, cq=30,
                    extra=[("tune-content", "screen")]),
    # deblock and CDEF with real strengths on 8-bit 4:2:0
    "cdef_mid": dict(w=128, h=96, n=1, cq=40, noise=20,
                     extra=[("enable-cdef", "1")]),
    # smoother content at a slow preset: self-guided restoration units
    # (the host LR tail)
    "lr_sgr": dict(w=128, h=96, n=1, cq=35, cpu=1, noise=25, xscale=30.0,
                   extra=[("enable-restoration", "1")]),
}


def _encode_small(name, spec, path):
    import aomffi
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    w, h = spec["w"], spec["h"]
    bd = spec.get("bit_depth", 8)
    ss = spec.get("subsampling", (1, 1))
    mono = spec.get("mono", False)
    noise = spec.get("noise", 12)
    opts = [("enable-cdef", "0"), ("enable-restoration", "0"),
            ("cq-level", str(spec["cq"]))] + spec.get("extra", [])
    enc = aomffi.AomEncoder(w, h, bit_depth=bd, subsampling=ss,
                            cpu_used=spec.get("cpu", 6), kf_max_dist=1,
                            lag=0, options=opts, monochrome=mono,
                            end_usage=3,
                            superres_denom=spec.get("superres_denom"))
    hi = 1 << bd
    dt = np.uint16 if bd > 8 else np.uint8
    yy, xx = np.mgrid[:h, :w]
    pkts = []
    for i in range(spec["n"]):
        if name == "palette":
            # flat 4-colour tiles with sharp edges
            cols = np.array([16, 90, 170, 235])
            y = cols[((xx // 8) + (yy // 8) * 3 + i) % 4].astype(dt)
        else:
            y = (hi // 2 + (hi // 4) * np.sin(xx / spec.get("xscale", 9.0)) * np.cos(yy / 11.0)
                 + rng.normal(0, noise * hi / 256, (h, w))) \
                .clip(0, hi - 1).astype(dt)
        if mono:
            u = v = None
        else:
            sx, sy = ss
            cw, ch = (w + sx) >> sx, (h + sy) >> sy
            u = (hi // 2 + rng.normal(0, 10 * hi / 256, (ch, cw))) \
                .clip(0, hi - 1).astype(dt)
            v = (hi // 2 + rng.normal(0, 10 * hi / 256, (ch, cw))) \
                .clip(0, hi - 1).astype(dt)
        pkts += enc.encode(y, u, v, pts=i)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, w, h)


def _encode_1080p(path, cq=40, superres_denom=None):
    """Same content, encoder settings and seed as bench.ensure_stream (at
    cq-level `cq`, with superres at `superres_denom` if given)."""
    import aomffi
    W, H, FRAMES = 1920, 1080, 8
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:H, :W]
    enc = aomffi.AomEncoder(
        W, H, cpu_used=6, kf_max_dist=1, lag=0,
        options=[("cq-level", str(cq)), ("tile-columns", "1"),
                 ("tile-rows", "1")], end_usage=3,
        superres_denom=superres_denom)
    pkts = []
    for i in range(FRAMES):
        y = (110 + 70 * np.sin(xx / 17.0 + i * 0.3) *
             np.cos(yy / 23.0 - i * 0.2) +
             rng.normal(0, 12, (H, W))).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin(xx[:H // 2, :W // 2] / 13.0 + i * 0.1) +
             rng.normal(0, 8, (H // 2, W // 2))).clip(0, 255) \
            .astype(np.uint8)
        v = (128 + 40 * np.cos(yy[:H // 2, :W // 2] / 15.0) +
             rng.normal(0, 8, (H // 2, W // 2))).clip(0, 255) \
            .astype(np.uint8)
        pkts += enc.encode(y, u, v, pts=i)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, W, H)


def _encode_1080p_inter(path, frames=8, cpu=6, tools=_SIMPLE_TOOLS, cq=40,
                        lag=0):
    """Same content, encoder settings and seed as
    bench.ensure_inter_stream (by default: `frames`, `cpu`, the inter
    `tools` options, `cq` and the encoder's `lag` vary it)."""
    import aomffi
    W, H, FRAMES = 1920, 1080, frames
    rng = np.random.default_rng(17)
    pad = 64
    yy, xx = np.mgrid[:H + pad, :W + pad]
    base_y = (110 + 70 * np.sin(xx / 17.0) * np.cos(yy / 23.0) +
              rng.normal(0, 10, (H + pad, W + pad))).clip(0, 255) \
        .astype(np.uint8)
    base_u = (128 + 40 * np.sin(xx[::2, ::2] / 13.0)).clip(0, 255) \
        .astype(np.uint8)
    base_v = (128 + 40 * np.cos(yy[::2, ::2] / 15.0)).clip(0, 255) \
        .astype(np.uint8)
    enc = aomffi.AomEncoder(
        W, H, cpu_used=cpu, kf_max_dist=9999, lag=lag, end_usage=3,
        options=[("cq-level", str(cq))] + tools)
    pkts = []
    for i in range(FRAMES):
        dy, dx = 2 * i, 3 * i
        y = base_y[dy:dy + H, dx:dx + W]
        u = base_u[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2]
        v = base_v[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2]
        pkts += enc.encode(y, u, v, pts=i)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, W, H)


# BIG_HOST: the inter tools of the host pixel path on (libaom's
# defaults), masked compound off, at cpu-used 3 (the battery's `warp`
# and `obmc` recipes need it for the encoder to pick those tools), and
# cq-level 44: at 36, 38, 40 and 42 the key frame has U pixels that the
# reference's device Wiener restoration decodes unlike libaom (ROADMAP
# queue 3)
HOST_CQ = 44
HOST_TOOLS = [("enable-obmc", "1"), ("enable-warped-motion", "1"),
              ("enable-global-motion", "1"),
              ("enable-interintra-comp", "1"),
              ("enable-masked-comp", "0")]
# BIG_HOST at cq-level 40: its key frame has the Wiener restoration
# units whose stripe-boundary rows the reference's device pass filters
# unlike the spec (ROADMAP queue 3; repaired in the port's
# ops/kernels/lr.py); no encode of this content at 640x576 or smaller
# has two chroma restoration-unit rows, so none shows the fault
BIG_HOST40 = "bench_1080p_host_cq40"
# the 1080p compound stream: bench.py's inter content with lag 8,
# alt-ref frames and distance-weighted compound on, OBMC, warp, masked
# compound, inter-intra and global motion off; at cpu-used
# COMPOUND_CPU most inter frames carry compound blocks
BIG_COMPOUND = "bench_1080p_compound"
COMPOUND_CPU = 1
COMPOUND_FRAMES = 10
COMPOUND_TOOLS = _SIMPLE_TOOLS + [("enable-dist-wtd-comp", "1"),
                                  ("auto-alt-ref", "1")]
# streams held to libaom through the port's decode (the reference's
# differs from libaom on them)
PORT_CHECKED = set(COMPOUND_CASES) | {BIG_COMPOUND, BIG_HOST40,
                                      OCCLUSION_CASE}


def _encode_inter(name, path):
    """A gen_inter_battery stream (its seed is the crc32 of `name`)."""
    import gen_inter_battery as gb
    spec = INTER_CASES.get(name) or COMPOUND_CASES.get(name) or \
        gb.CASES[name]
    if os.path.exists(path):
        os.remove(path)
    assert gb.gen_case(name, spec, os.path.dirname(path)) == path


def display_md5(planes, bit_depth):
    """MD5 of a frame's planes as uint8 (8-bit) or uint16 bytes."""
    h = hashlib.md5()
    dt = np.uint16 if bit_depth > 8 else np.uint8
    for p in planes:
        h.update(np.ascontiguousarray(p, dt).tobytes())
    return h.hexdigest()


def check_stream(path, host=False):
    """(oracle per-frame MD5s, True when the JAX reference decodes every
    frame to the oracle's pixels on its device path, or with `host` on
    its device and host paths, and no inter block has a second
    reference; the reference's recon path of every coded frame).  The
    MD5 covers the coded planes (Y only for monochrome) at the displayed
    size, with film grain as the oracle applies it; the JAX decoder's
    planes are cropped to it."""
    import aomffi
    from av1dec_tpu.api import Decoder
    from av1dec_tpu.bindings import NativeParser
    from av1dec_tpu.config import DecoderConfig
    from av1dec_tpu.container import read_ivf
    oracle = aomffi.oracle_decode_ivf(path)
    parser = NativeParser()
    compound = False
    for _, tu in read_ivf(path):
        for _, plans in parser.parse_tu(tu, with_plans=True):
            if plans is not None:
                inter = np.asarray(plans.grid("is_inter")) != 0
                compound |= bool((np.asarray(plans.grid("ref1"))[inter]
                                  > 0).any())
    parser.close()
    dec = Decoder(DecoderConfig(platform="cpu"))
    frames = []
    for _, tu in read_ivf(path):
        frames += dec.decode(tu)
    paths = [s["recon_path"] for s in dec.stats]
    dec.close()
    md5s = []
    same = not compound and len(frames) == len(oracle) and \
        (host or all(p == "device" for p in paths))
    if compound:
        print(f"{os.path.basename(path)}: a compound block", flush=True)
    for fr, ora in zip(frames, oracle):
        ref = [ora.y, ora.u, ora.v][:len(fr.planes)]
        same = same and all(
            np.array_equal(np.asarray(p)[:r.shape[0], :r.shape[1]], r)
            for p, r in zip(fr.planes, ref))
        md5s.append(display_md5(ref, ora.bit_depth))
    return md5s, same, paths


def check_stream_port(path):
    """(oracle per-frame MD5s, True when the port's decoder on the CPU
    decodes every frame to the oracle's pixels, the port's recon path of
    every coded frame).  For the streams whose compound frames (or
    Wiener stripe rows) the reference decodes unlike libaom: the port's
    repaired copies are held to libaom instead, and its paths are the
    reference's (`device_inter.ineligible_reason` refuses what the
    reference's `frame_eligible` refuses)."""
    import aomffi
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.container import read_ivf
    oracle = aomffi.oracle_decode_ivf(path)
    dec = Decoder(device="cpu")
    frames = []
    for _, tu in read_ivf(path):
        frames += dec.decode(tu)
    paths = [s["recon_path"] for s in dec.stats]
    dec.close()
    same = len(frames) == len(oracle)
    md5s = []
    for fr, ora in zip(frames, oracle):
        ref = [ora.y, ora.u, ora.v][:len(fr.planes)]
        same = same and all(
            np.array_equal(np.asarray(p)[:r.shape[0], :r.shape[1]], r)
            for p, r in zip(fr.planes, ref))
        md5s.append(display_md5(ref, ora.bit_depth))
    return md5s, same, paths


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-1080p", action="store_true")
    ap.add_argument("--only", nargs="*")
    args = ap.parse_args()
    from conftest import SPEC_CASES
    os.makedirs(OUT, exist_ok=True)
    man_path = os.path.join(OUT, "manifest.json")
    manifest = {}
    if os.path.exists(man_path):
        with open(man_path) as f:
            manifest = json.load(f)
    cases = dict(SPEC_CASES, **EXTRA_CASES)
    names = args.only or (sorted(cases) + BATTERY + sorted(INTER_CASES) +
                          HOST_CASES + [GOP_CASE] + sorted(COMPOUND_CASES) +
                          [OCCLUSION_CASE])
    if not args.skip_1080p and not args.only:
        names = names + [BIG, BIG_LF, BIG_SRES, BIG_INTER, BIG_HOST,
                         BIG_HOST40, BIG_COMPOUND]
    for name in names:
        path = os.path.join(OUT, name + ".ivf")
        if name == BIG:
            _encode_1080p(path)
        elif name == BIG_LF:
            _encode_1080p(path, LF_CQ)
        elif name == BIG_SRES:
            _encode_1080p(path, superres_denom=SRES_DENOM)
        elif name == BIG_INTER:
            _encode_1080p_inter(path)
        elif name == BIG_HOST:
            _encode_1080p_inter(path, HOST_FRAMES, 3, HOST_TOOLS, HOST_CQ)
        elif name == BIG_HOST40:
            _encode_1080p_inter(path, HOST_FRAMES, 3, HOST_TOOLS, 40)
        elif name == BIG_COMPOUND:
            _encode_1080p_inter(path, COMPOUND_FRAMES, COMPOUND_CPU,
                                COMPOUND_TOOLS, 40, lag=8)
        elif name == GOP_CASE:
            _encode_gops(path)
        elif name == OCCLUSION_CASE:
            _encode_occlusion(path)
        elif name in cases:
            _encode_small(name, cases[name], path)
        else:
            _encode_inter(name, path)
        host = name in HOST_CASES or name in PORT_CHECKED or \
            name in (BIG_HOST, GOP_CASE)
        if name in PORT_CHECKED:
            ref, same, paths = check_stream_port(path)
            if name in (BIG_COMPOUND, "ra_bd10"):
                same = same and all(p == "device" for p in paths)
        else:
            ref, same, paths = check_stream(path, host)
        size = os.path.getsize(path)
        if not same:
            print(f"DROP {name}: the reference (or, for PORT_CHECKED, the "
                  f"port) != libaom, or a compound block outside "
                  f"PORT_CHECKED, or (not a host case) a frame on the host "
                  f"path", flush=True)
            os.remove(path)
            manifest.pop(name, None)
            continue
        manifest[name] = {"frames": ref, "bytes": size}
        if name in (BIG_INTER, BIG_HOST, BIG_HOST40, BIG_COMPOUND) or \
                name not in cases and name not in (BIG, BIG_LF, BIG_SRES):
            manifest[name]["inter"] = True
        if host:
            manifest[name]["host"] = True
            manifest[name]["paths"] = paths
        print(f"keep {name}: {len(ref)} frames, {size} bytes, recon paths "
              f"{paths}", flush=True)
    with open(man_path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
