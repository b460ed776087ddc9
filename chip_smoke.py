"""Smoke run of av1dec_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. card and build: the card's name, power limit and maximum SM clock,
   the g++ build of the native front end and the nvcc build of every
   CUDA kernel, with times;
2. kernels, each against its plain torch version on the card, byte-equal,
   on random inputs:
   - `cdef_frame` (the frame kernel of the main path) against
     `_cdef_core`: 4:2:0, 4:2:2, 4:4:4 and mono at 72x136, 8- and 10-bit,
     strengths mixed, all zero, primary only and secondary only, with
     direction-tie luma blocks, and 1080p 4:2:0 at 8 and 10 bits;
   - `cdef_filter` (the per-plane kernel that takes a caller's pad)
     against `_filter_plane` at the test shapes and the main path's plane
     shapes (8- and 10-bit), and with a caller pad;
   then each kernel's device time (torch.profiler: kernel time only, no
   host cost) and its wrapper-inclusive time at 1080p 4:2:0, beside the
   plain version's time and the bound for the same inputs;
3. main path: `decode_stream_batched(device="cuda")` on the committed
   1080p 8-frame all-intra stream: every frame's MD5 against the
   committed manifest, one `cdef_frame` launch per frame with CDEF on
   and no `cdef_filter` launch, then a timed pass with fps and per-stage
   ms; then the frame kernel's device time and bound on the stream's own
   first frame (its planes after deblock and its real strengths);
4. entry point: `api.Decoder(device="cuda")` on every committed small
   stream against the manifest, one `cdef_frame` launch per frame with
   CDEF on.

Prints a `{"kernels": [...]}` line, the card's name and power limit, and
as its last line `{"ok": true, "device": {...}}`.  Exits non-zero without
a result when no CUDA device is present.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(_REPO, "av1dec_tpu_torch", "testdata")
BIG = "bench_1080p_intra"
# H100 SXM data sheet: HBM3 rate
HBM_BYTES_PER_S = 3.35e12
# int32 add, compare, min/max, shift and multiply-add results per clock
# per SM at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput); the int32 rate is this x SMs x the
# maximum SM clock (`int32_ops_per_s`)
INT32_PER_CLOCK_PER_SM = 64
# int32 operations of the CDEF filter: per tap that is on (load, compare,
# subtract, abs, shift, subtract, max, min, sign, multiply-add, min,
# max), and per filtered pixel (rounding and clip); a pixel of a unit
# with nothing to apply is a copy (no operation)
CDEF_OPS_PER_TAP = 12
CDEF_OPS_PER_PX = 8
# int32 operations of the direction search of one 8x8 unit: 64 x (shift,
# subtract) to centre the pixels, 8 x 64 partial-sum adds, 8 x 30 for the
# squares and weighted sums of the costs, 16 for the first maximum
DIR_OPS_PER_UNIT = 64 * 2 + 8 * 64 + 8 * 30 + 16
# (subx, suby) of each chroma format; None is mono
FORMATS = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "mono": None}
GATES = ("mixed", "zero", "pri_only", "sec_only", "all_taps")


def log(msg):
    print(msg, flush=True)


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card_line():
    return smi("name,power.limit")


def int32_ops_per_s():
    """SMs x int32 results per clock per SM x the maximum SM clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_PER_CLOCK_PER_SM * mhz * 1e6


def cuda_ms(fn, iters):
    """Mean milliseconds of fn() on the card (CUDA events around a warm
    loop of calls: host cost of the calls included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_ms(fn, name, iters):
    """Mean device milliseconds, per fn() call, of the kernels whose name
    holds `name`: torch.profiler's device intervals of those kernels over
    a warm loop of calls, so no host cost is counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    if not ev:
        raise RuntimeError(f"the profiler recorded no {name} kernel")
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / iters


def bound(nbytes, ops, int_rate):
    """(bound ms, what sets it) of work of `nbytes` and `ops`."""
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / int_rate * 1e3
    return (b_ops, "operations") if b_ops > b_bytes else (b_bytes, "bytes")


def filter_ops(apply, pri_on, sec_on, px):
    """int32 operations of the filter: `px` pixels for each unit of the
    boolean per-unit tensors."""
    taps = 4 * pri_on.long() + 8 * sec_on.long()
    per_px = torch.where(apply, CDEF_OPS_PER_PX + CDEF_OPS_PER_TAP * taps,
                         torch.zeros_like(taps))
    return int(per_px.sum()) * px


def frame_work(planes, gates, bd, subx, suby):
    """(bytes, int32 operations) that CDEF of one frame needs with these
    inputs: the planes read and written once and the strengths read once;
    the direction search of each unit with a primary strength, and the
    taps that are on in each unit with something to apply."""
    from av1dec_tpu_torch.ops.kernels.cdef import _directions, _ilog2
    y_pri, y_sec, uv_pri, uv_sec = gates
    chroma = len(planes) > 1
    _, var = _directions(planes[0], bd)
    pri_adj = torch.where((y_pri > 0) & (var != 0),
                          (y_pri * (4 + _ilog2(var >> 6)) + 8) >> 4, 0)
    ops = filter_ops((pri_adj > 0) | (y_sec > 0), pri_adj > 0, y_sec > 0, 64)
    search = y_pri > 0
    if chroma:
        ops += filter_ops((uv_pri > 0) | (uv_sec > 0), uv_pri > 0,
                          uv_sec > 0, 2 * (64 >> (subx + suby)))
        search = search | (uv_pri > 0)
    ops += int(search.sum()) * DIR_OPS_PER_UNIT
    nbytes = sum(2 * 4 * p.numel() for p in planes) + \
        (4 if chroma else 2) * 4 * y_pri.numel()
    return nbytes, ops


def frame_inputs(rng, H, W, bd, fmt, gates, dev):
    """Random planes (with direction-tie luma blocks) and gated
    per-8x8-unit strengths on `dev`: (planes, gates, damping, subx,
    suby).  "all_taps" turns every primary and secondary tap of every
    unit on."""
    cs = bd - 8
    luma = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    luma[:8, :8] = 77 << cs
    luma[:8, 8:16] = ((np.indices((8, 8)).sum(0) % 2) * 200) << cs
    luma[8:16, :8] = (np.arange(8)[None, :] * 30) << cs
    luma[8:16, 8:16] = (np.arange(8)[:, None] * 30) << cs
    luma[16:24, :8] = ((np.indices((8, 8)).sum(0) % 3) * 100) << cs
    planes = [luma]
    sub = FORMATS[fmt]
    subx, suby = sub if sub else (0, 0)
    if sub:
        for _ in range(2):
            planes.append(rng.integers(
                0, 1 << bd, (H >> suby, W >> subx)).astype(np.int32))
    shape = (H // 8, W // 8)
    everywhere = gates == "all_taps"

    def gate(choices, on):
        u = rng.choice(choices, shape) << cs
        keep = everywhere | (rng.random(shape) < 0.8)
        return np.where(keep & on, u, 0).astype(np.int32)

    pri = np.arange(1, 16) if everywhere else np.arange(16)
    sec = [1, 2, 4] if everywhere else [0, 1, 2, 4]
    pri_on = gates in ("mixed", "pri_only", "all_taps")
    sec_on = gates in ("mixed", "sec_only", "all_taps")
    g = [gate(pri, pri_on), gate(sec, sec_on), gate(pri, pri_on),
         gate(sec, sec_on)]
    damping = int(rng.integers(3, 7)) + cs
    return (tuple(torch.as_tensor(p, device=dev) for p in planes),
            [torch.as_tensor(x, device=dev) for x in g], damping, subx,
            suby)


def filter_inputs(rng, H, W, bd, dev):
    """A random plane and random per-8x8-unit CDEF maps (primary and
    secondary strengths, all 8 directions), as _cdef_core builds them;
    also the per-unit (apply, pri > 0, sec > 0) for the work count."""
    cs = bd - 8
    uH, uW = (H + 7) // 8, (W + 7) // 8

    def expand(u):
        px = np.repeat(np.repeat(u, 8, 0), 8, 1)[:H, :W]
        return torch.as_tensor(np.ascontiguousarray(px, np.int32),
                               device=dev)

    def shift_for(s, d):
        return np.maximum(0, d - np.floor(np.log2(np.maximum(s, 1)))
                          .astype(np.int64))

    pri_u = rng.integers(0, 16, (uH, uW)) << cs
    sec_u = rng.choice([0, 1, 2, 4], (uH, uW)) << cs
    dir_u = rng.integers(0, 8, (uH, uW))
    damping = int(rng.integers(3, 7)) + cs
    plane = torch.as_tensor(rng.integers(0, 1 << bd, (H, W)).astype(np.int32),
                            device=dev)
    apply_u = (pri_u > 0) | (sec_u > 0)
    maps = [expand(pri_u), expand(sec_u), expand(dir_u),
            expand(shift_for(pri_u, damping)),
            expand(shift_for(sec_u, damping)),
            expand(apply_u.astype(np.int32))]
    units = tuple(torch.as_tensor(a) for a in (apply_u, pri_u > 0, sec_u > 0))
    return plane, maps, cs, units


def check_frame(cdef, planes, gates, bd, damping, subx, suby, what):
    got = cdef.cdef_frame(planes, *gates, bd, damping, subx, suby)
    ref = cdef._cdef_core(planes, *gates, bd, damping, subx, suby)
    if len(got) != len(ref):
        raise AssertionError(f"cdef_frame {what}: {len(got)} planes, "
                             f"plain {len(ref)}")
    err = 0
    for g, r in zip(got, ref):
        err = max(err, int((g - r).abs().max()))
    if err:
        raise AssertionError(f"cdef_frame != plain at {what}: max abs err "
                             f"{err}")
    return err


def time_frame(cdef, planes, gates, bd, damping, subx, suby, int_rate,
               what, plain_iters=5):
    """The frame kernel's device ms, wrapper-inclusive ms, plain ms and
    bound for one frame's inputs; logged and returned as a dict."""
    def run():
        cdef.cdef_frame(planes, *gates, bd, damping, subx, suby)
    k = kernel_ms(run, "cdef_frame_kernel", 50)
    w = cuda_ms(run, 50)
    p = cuda_ms(lambda: cdef._cdef_core(planes, *gates, bd, damping, subx,
                                        suby), plain_iters)
    nbytes, ops = frame_work(planes, gates, bd, subx, suby)
    b, by = bound(nbytes, ops, int_rate)
    log(f"cdef_frame {what}: device {k:.4f} ms (wrapper-inclusive "
        f"{w:.4f} ms), plain {p:.4f} ms, bound {b:.4f} ms ({by}; "
        f"{nbytes} bytes, {ops} int32 ops), {b / k:.3f} of the bound")
    return {"ms": k, "wrapper_ms": w, "plain_ms": p, "bound_ms": b,
            "bound_by": by}


def phase_kernels(dev, int_rate):
    """Each CUDA kernel == its plain torch version, on the card; returns
    the kernels' measurements."""
    from av1dec_tpu_torch.ops.kernels import cdef
    rng = np.random.default_rng(2024)
    # the frame kernel
    n = max_frame = 0
    for fmt in FORMATS:
        for bd in (8, 10):
            for gates in GATES:
                planes, g, damping, sx, sy = frame_inputs(
                    rng, 72, 136, bd, fmt, gates, dev)
                max_frame = max(max_frame, check_frame(
                    cdef, planes, g, bd, damping, sx, sy,
                    f"72x136 {fmt} {bd}-bit {gates}"))
                n += 1
    for bd in (8, 10):
        for gates in ("mixed", "all_taps"):
            planes, g, damping, sx, sy = frame_inputs(
                rng, 1080, 1920, bd, "420", gates, dev)
            max_frame = max(max_frame, check_frame(
                cdef, planes, g, bd, damping, sx, sy,
                f"1080x1920 420 {bd}-bit {gates}"))
            n += 1
    log(f"kernel cdef_frame: byte-equal to _cdef_core on {n} frames "
        f"(72x136 in 4 formats x 8/10-bit x {len(GATES)} strength kinds, "
        f"1080p 4:2:0 8/10-bit; max abs err {max_frame})")

    # the per-plane kernel
    max_err = 0
    for (H, W) in [(64, 64), (40, 72), (24, 128), (1080, 1920), (540, 960)]:
        for bd in (8, 10):
            plane, maps, cs, _ = filter_inputs(rng, H, W, bd, dev)
            got = cdef.filter_plane(plane, *maps, cs)
            ref = cdef._filter_plane(plane, *maps, cs)
            err = int((got - ref).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"cdef_filter != plain at {H}x{W} "
                                     f"{bd}-bit: max abs err {err}")
    # a caller-built border (the column-sharded path's halos): the taps
    # read the pad everywhere, the centre pixel the plane; a fully random
    # pad tells the two apart
    plane, maps, cs, _ = filter_inputs(rng, 64, 96, 8, dev)
    pad = torch.as_tensor(rng.integers(0, 256, (68, 100)).astype(np.int32),
                          device=dev)
    got = cdef.filter_plane(plane, *maps, cs, pad=pad)
    ref = cdef._filter_plane(plane, *maps, cs, pad=pad)
    if not torch.equal(got, ref):
        raise AssertionError("cdef_filter != plain with a caller pad")
    log(f"kernel cdef_filter: byte-equal to _filter_plane on 5 shapes x "
        f"8/10-bit + caller pad (max abs err {max_err})")

    # times at 1080p 4:2:0: the frame kernel on random all-tap strengths
    planes, g, damping, sx, sy = frame_inputs(rng, 1080, 1920, 8, "420",
                                              "all_taps", dev)
    frame = time_frame(cdef, planes, g, 8, damping, sx, sy, int_rate,
                       "1080p 4:2:0 8-bit, random all-tap strengths")
    frame["max_abs_err"] = max_frame
    # the per-plane kernel: one luma and two chroma launches a frame
    t_k = t_w = t_p = nbytes = ops = 0
    for (H, W), reps in (((1080, 1920), 1), ((540, 960), 2)):
        plane, maps, cs, (app, pon, son) = filter_inputs(rng, H, W, 8, dev)

        def run():
            cdef.filter_plane(plane, *maps, cs)
        k = kernel_ms(run, "cdef_filter_kernel", 50)
        w = cuda_ms(run, 50)
        p = cuda_ms(lambda: cdef._filter_plane(plane, *maps, cs), 5)
        # each input read once (plane + 6 maps), the output written once
        nb = H * W * 4 * (1 + 6 + 1)
        op = filter_ops(app, pon, son, 64)
        log(f"cdef_filter {H}x{W}: device {k:.4f} ms (wrapper-inclusive "
            f"{w:.4f} ms), plain {p:.4f} ms")
        t_k += reps * k
        t_w += reps * w
        t_p += reps * p
        nbytes += reps * nb
        ops += reps * op
    b, by = bound(nbytes, ops, int_rate)
    log(f"cdef_filter 1080p 4:2:0 frame (3 launches): device {t_k:.4f} ms "
        f"(wrapper-inclusive {t_w:.4f} ms), plain {t_p:.4f} ms, bound "
        f"{b:.4f} ms ({by}; {nbytes} bytes, {ops} int32 ops), "
        f"{b / t_k:.3f} of the bound")
    filt = {"max_abs_err": max_err, "ms": t_k, "wrapper_ms": t_w,
            "plain_ms": t_p, "bound_ms": b, "bound_by": by}
    return frame, filt


def cdef_frames(datas):
    """Frames of the stream whose CDEF is on (host gating)."""
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.ops.kernels.cdef import compute_gates
    parser = NativeParser()
    n = 0
    for d in datas:
        for hdr, plans in parser.parse_tu(d, with_plans=True):
            seq = parser.seq
            planes = 1 if seq["mono_chrome"] else 3
            n += compute_gates(seq, hdr, plans, planes,
                               seq["bit_depth"]) is not None
    parser.close()
    return n


def check_launches(cdef, n_cdef, what):
    """One frame-kernel launch per frame with CDEF on, none of the
    per-plane kernel."""
    if cdef.frame_launches != n_cdef or cdef.launches != 0:
        raise AssertionError(
            f"{what}: cdef_frame launches {cdef.frame_launches} != "
            f"{n_cdef} frames with CDEF on, or cdef_filter launches "
            f"{cdef.launches} != 0")


def phase_main_path(manifest, dev, int_rate):
    from av1dec_tpu_torch.api import STAGES, decode_stream_batched
    from av1dec_tpu_torch.api import display_md5
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.ops.kernels import cdef
    datas = [d for _, d in read_ivf(os.path.join(TESTDATA, BIG + ".ivf"))]
    want = manifest[BIG]["frames"]
    n_cdef = cdef_frames(datas)

    cdef.launches = cdef.frame_launches = 0
    t0 = time.perf_counter()
    out = decode_stream_batched(datas, device=dev, batch=4)
    t_first = time.perf_counter() - t0
    launches = cdef.frame_launches
    check_launches(cdef, n_cdef, "main path")
    if launches == 0:
        raise AssertionError("main path: no frame with CDEF on")
    got = [display_md5(p, 8, 1920, 1080, (1, 1)) for p in out]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        raise AssertionError(f"1080p frames differ from the manifest: "
                             f"{bad} of {len(want)}")
    log(f"main path: {len(got)}/{len(want)} frames of {BIG} match the "
        f"manifest; cdef_frame launches {launches} = {n_cdef} frames with "
        f"CDEF on, cdef_filter launches 0; the scan ran under sync debug "
        f"mode 'error' (no device->host sync); first pass {t_first:.3f} s")

    t0 = time.perf_counter()
    decode_stream_batched(datas, device=dev, batch=4)
    dt = time.perf_counter() - t0
    tm = {}
    decode_stream_batched(datas, device=dev, batch=4, timings=tm)
    stages = {k: round(tm[k] * 1e3 / len(datas), 3) for k in STAGES}
    log(json.dumps({"fps_1080p_intra": len(datas) / dt,
                    "seconds": dt, "frames": len(datas),
                    "stage_ms_per_frame": stages, "card": card_line()}))

    # the frame kernel on the stream's first frame, as the chain gives it
    seen = []
    real = cdef.cdef_frame

    def keep(*args):
        seen.append(args)
        return real(*args)
    cdef.cdef_frame = keep
    try:
        decode_stream_batched(datas[:1], device=dev, batch=1)
    finally:
        cdef.cdef_frame = real
    planes, *gates, bd, damping, sx, sy = seen[0]
    time_frame(cdef, planes, gates, bd, damping, sx, sy, int_rate,
               f"{BIG} frame 0 (real strengths)")
    return launches


def phase_entry_point(manifest, dev):
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.ops.kernels import cdef
    names = sorted(n for n in manifest if n != BIG)
    n_cdef = 0
    cdef.launches = cdef.frame_launches = 0
    for name in names:
        dec = Decoder(DecoderConfig(apply_grain=False), device=dev)
        got = []
        datas = [tu for _, tu in read_ivf(os.path.join(TESTDATA,
                                                       name + ".ivf"))]
        for tu in datas:
            got += [f.display_md5() for f in dec.decode(tu)]
        dec.close()
        n_cdef += cdef_frames(datas)
        if got != manifest[name]["frames"]:
            raise AssertionError(f"{name}: Decoder(device='cuda') frames "
                                 f"differ from the manifest")
    check_launches(cdef, n_cdef, "small streams")
    log(f"entry point: Decoder(device='cuda') matches the manifest on "
        f"{len(names)} streams: {' '.join(names)}; cdef_frame launches "
        f"{n_cdef} = frames with CDEF on, cdef_filter launches 0")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, _REPO)
    from av1dec_tpu_torch import bindings
    from av1dec_tpu_torch.ops.kernels import cuda_build

    dev = torch.device("cuda")
    card = card_line()
    int_rate = int32_ops_per_s()
    log(f"card: {card}; max SM clock {smi('clocks.max.sm')}; int32 rate "
        f"{int_rate:.4g} ops/s; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    t_native = bindings.build_native()
    t_cuda = cuda_build.build_kernels(verbose=True)
    log(f"build: native front end (g++) {t_native:.2f} s, CUDA kernels "
        f"(nvcc, {len(cuda_build.KERNELS)} in parallel) {t_cuda:.2f} s")
    with open(os.path.join(TESTDATA, "manifest.json")) as f:
        manifest = json.load(f)

    frame, filt = phase_kernels(dev, int_rate)
    launches = phase_main_path(manifest, dev, int_rate)
    phase_entry_point(manifest, dev)

    def line(name, replaces, k, n):
        return {"name": name, "route": "cuda",
                "source": f"av1dec_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}
    log(json.dumps({"kernels": [
        line("cdef_frame", "av1dec_tpu/ops/kernels/cdef.py:342", frame,
             launches),
        line("cdef_filter", "av1dec_tpu/ops/kernels/cdef.py:342", filt, 0),
    ]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
