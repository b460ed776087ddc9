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
   - `cdef_filter` (the kernel of one column shard, from its planes'
     bordered copies) against `_cdef_shard_core`, one launch a shard:
     72x160 frames in the 4 formats, 8- and 10-bit, the 5 strength
     kinds, cut into 1, 2 and 4 shards (widths 160, 80 and 40), and
     1080p 4:2:0 at 8 and 10 bits in 2 and 4 shards (960, 480), each
     with the pads `cdef_local` builds and (but 1080p all-tap) with
     random values in their halo columns;
   then the frame kernel's device time (torch.profiler: kernel time
   only, no host cost) and its wrapper-inclusive time at 1080p 4:2:0,
   beside the plain version's time and the bound for the same inputs;
   - `wavefront_scan` (the scan kernel, one persistent launch per batch,
     its lanes in level-major ticket order waiting on device counters)
     against `_scan_plain` on the same buffer after the MC pass,
     byte-equal, each batch SCAN_REPEATS times (a stale edge pixel is a
     race that shows only on some runs): the first 4-frame batch of the
     1080p all-intra stream, every small stream's first batch (up to 4
     frames without inter lanes) and first frame with MF_INTER lanes, as
     `Decoder(device="cuda")` builds them (8 and 10 bits; 4:2:0, 4:4:4
     and mono), and frame 1 of the 1080p low-delay stream (MF_INTER
     lanes); one launch a batch whose counters report every level with
     lanes complete; then, on the 1080p batch and that inter frame, its
     device time (its kernel interval), wrapper-inclusive time, the
     plain version's time and the bound (bytes, operations, and the
     chain term: the device time of `wavefront_scan_floor`, the same
     tickets, waits and publishes with no pixel work); each of these
     batches whose coded levels went up (no quantizer matrix, no
     lossless block) also holds `itx` on the device path, the scan's
     residual buffer from `prep_batch`'s packed levels with each
     block's `out` at its slot, to `_residuals_plain` on the card,
     byte-equal on every word the blocks cover;
   - `mc` (the MC pass, one launch for every bucket of a frame) against
     `_mc_plain`, byte-equal, MC_REPEATS runs each, the trash slot
     never written: seeded lanes of every T from 4 to 128, single-list,
     average and distance-weighted compound, past every edge of the
     reference, partial w x h, at 8 bits (uint8 and int32 references),
     10 and 12 bits, in small reference pieces (most window rows
     clamped) and in pieces larger than any window (most rows copied
     with cp.async, at every offset of a 16-byte chunk) (the real lanes
     of a 1080p inter and compound frame in phases 5 and 8a, where their
     decodes capture them);
   - `itx` (B7, the device residuals: every block of a call in one
     launch, from `itx.pack_buckets`' buffer) against the plain route
     on the card (`_residuals_plain`: `residual_bucket` a bucket), its
     CPU run and the NumPy spec model, on every valid (tx_size,
     tx_type) at 8, 10 and 12 bits, one call a bit depth, ITX_REPEATS
     runs; on extreme levels, where the plain route wraps in int32,
     and on spans of 65 blocks of every tx_size (several CTAs each, the
     last part-filled), against the plain route and its CPU run;
   - the postfilter kernels, each against its plain version on the card,
     byte-equal, POST_REPEATS runs a check: `deblock` (both passes of
     every plane, one launch a frame) against `_deblock_plain` on seeded
     61x83 frames in the 4 formats at 8, 10 and 12 bits with sharpness
     0, 3 and 7, maps with every length (0, 4, 6, 8, 14) beside every
     other and cell rows all 14 (wide filters that write each other's
     pixels), as large as the planes' cells, smaller and larger, the
     planes read in place through a row stride, and on 1080p 4:2:0 at 8
     and 10 bits; and on maps whose lengths follow the transform sizes,
     as a stream's do (each pixel written by one edge at most: 61x83 in
     the 4 formats at 8 and 12 bits, sharpness 0 and 7, and 1080p 4:2:0
     at 8 and 10 bits); `wiener` (every Wiener plane in one launch) against
     `_wiener_plain` on seeded units at 1080p 4:2:0 (8, 10, 12 bits),
     across stripe, unit-row and unit-column boundaries (the cq-40 key
     frame's own inputs in 8b); `superres` (every plane in one launch)
     against `_superres_plain` on 1080p 4:2:0 upscales built by
     `_superres_args`' arithmetic at denominators 9, 12, 14 and 16 and
     8, 10 and 12 bits, 3 planes or the final and the pre-CDEF planes
     (6 in one launch); then each kernel's
     device ms (torch.profiler), kernels a call, wrapper-inclusive ms,
     the plain version's device ms and kernels and its ms, and the bound
     (bytes and operations: `deblock_work`, `wiener_work`,
     `superres_work`) at 1080p 4:2:0 (deblock on both kinds of maps);
3. main path: `decode_stream_batched(device="cuda")` on the committed
   1080p 8-frame all-intra stream: every frame's MD5 against the
   committed manifest, one `cdef_frame` launch per frame with CDEF on
   and no `cdef_filter` launch, then a timed pass with fps and per-stage
   ms; then the frame kernel's device time and bound on the stream's own
   first frame (its planes after deblock and its real strengths);
   b. the same decode of the committed 1080p all-intra stream at cq-level
      55 (`bench_1080p_intra_lf`), whose every frame has a loop-filter
      level: every frame's MD5 against the manifest, every frame on the
      device path with one `deblock` launch, a timed pass (fps, per-stage
      ms, the `postfilter` stage among them); then `deblock` on frame
      0's own planes and maps, byte-equal to `_deblock_plain`
      POST_REPEATS runs, and its times against its bound
   c. the same decode of the committed 1080p all-intra stream with
      superres at denominator 16 (`bench_1080p_intra_sres`: every frame
      coded 960 wide, upscaled to 1920; libaom chose a loop-filter level
      in each and no restoration): every frame's MD5 against the
      manifest, every frame on the device path with exactly one
      `superres` launch, a timed pass (fps, per-stage ms); then
      `superres` on frame 0's own planes and tables, byte-equal to
      `_superres_plain` POST_REPEATS runs, and its times against its
      bound;
4. entry point: `api.Decoder(device="cuda")` on every committed small
   stream, intra and inter, against the manifest (film grain applied),
   each coded frame on the recon path the manifest records (the device
   path, or the host pixel path for the streams marked "host"), one
   `cdef_frame` launch per frame with CDEF on, on both paths;
5. inter path: `api.Decoder(device="cuda")` on the committed 1080p
   low-delay stream (1 key frame, 7 inter frames): every frame's MD5
   against the manifest, all 7 inter frames on the device path (MC pass,
   then the scan with MF_INTER lanes; both run under torch's sync debug
   mode "error"), one `cdef_frame` launch per frame with CDEF on and no
   `cdef_filter` launch; then a warm timed pass (fps, mean key-frame and
   inter-frame ms, host InterPlan ms), a pass with the postfilter stage
   clocked (`postfilter_clocked`: host ms a frame, the device
   synchronised around it) and, on one inter frame's real
   lanes (checked disjoint, and the kernel byte-equal to `_mc_plain`
   on them, MC_REPEATS runs), the MC pass's device time (torch.profiler:
   every device interval of one `mc_into` call on the scan's buffer, as
   the decoder makes it, no host cost), its kernel count, the kernel's
   own interval, its wrapper-inclusive time, the plain version's time
   and its bound;
6. host pixel path: `api.Decoder(device="cuda")` on the committed 1080p
   stream of the host path (1 key frame on the device path, 7 inter
   frames with local warped motion on the host path: `FrameRecon`, with
   B7 and `cdef_frame` on the card): every frame's MD5 against the
   manifest, the frames on the host path against the manifest's recon
   paths, one `cdef_frame` launch per frame with CDEF on and no
   `cdef_filter` launch; then a warm timed pass (`fps_1080p_host`, mean
   ms of the host-path and device-path frames, and the host-path frames'
   ms split by stage: residuals, block walk, the NumPy filters and CDEF,
   on the host clock) and, for the last host
   frame's residual buckets, B7's device time (torch.profiler: every
   device interval of one `residuals_device` call, upload and fetch
   included, no host cost), its kernel count, the `itx` kernel's own
   interval, its wrapper-inclusive time (packing included), the NumPy
   route's time on the same buckets (with which it is held equal), the
   plain route's on the card and its bound (bytes and operations);
7. state and scale-out:
   a. checkpoint: during phase 5's checked pass, `Decoder.save_state()`
      after TU 4; a fresh `Decoder(device="cuda")` loads it and decodes
      TUs 4-7, all on the device path, against the manifest (blob bytes,
      save and load ms);
   b. GOP-parallel: `container.decode_gops_parallel(workers=2,
      device="cuda")` on the first 4 TUs (4 GOPs) of the 1080p all-intra
      stream against the manifest (wall fps, each worker's frame ms);
   c. column-sharded CDEF: one launch of 4 ranks of
      `av1dec_tpu_torch.parallel.worker` on the card (gloo) runs
      `cdef_sharded` on phase 3's frame 0 (deblocked planes, real
      strengths) at n_space 2 and 4, each byte-equal to the plain
      `_cdef_core` on the whole frame (with which `cdef_frame` is held
      equal too), 1 `cdef_filter` launch per rank per call, byte-equal
      to the plain `_cdef_shard_core` on the same bordered planes and
      strengths (per-rank kernel device ms, wrapper-inclusive ms, the
      plain version's ms on the same inputs, halo-exchange ms, and the
      bound with both its terms);
   d. frame-sharded decode: in the same launch, `decode_frames_sharded`
      of frames 0-1 at data=2 against the manifest;
   e. NCCL: one rank whose backend the default rule picks (NCCL: it has
      a card of its own) runs c at n_space 1 (fill-only halos) through
      the CUDA-tensor path of the collectives;
8. compound frames and the last gaps:
   a. `api.Decoder(device="cuda")` on the committed 1080p compound
      stream (lag 8, compound blocks in 8 of 9 inter frames): every
      frame's MD5 and recon path against the manifest, all on the device
      path, the compound MC lanes counted (at least 1), one `cdef_frame`
      launch per frame with CDEF on; then a warm timed pass
      (`fps_1080p_compound`, mean key- and inter-frame ms), a pass with
      the postfilter stage clocked, and the MC pass of the last frame
      with compound lanes (checked as in 5; device, kernel, wrapper and
      plain ms, bound), as in 5;
   b. the key frame of the cq-40 host stream on the device path, its
      Wiener restoration on the device in one `wiener` launch, against
      the manifest; then the kernel on that frame's own inputs,
      byte-equal to `_wiener_plain`, and its times;
   c. `decode_stream_batched` on `screen`'s TU 0, an intra block copy
      key frame, inline on the host pixel path, against the manifest;
   d. `parallel.sharded_cdef.cdef_local` on phase 3's frame 0 in 2 and 4
      column shards on the card repeated, against `_cdef_core`, one
      `cdef_filter` launch a shard, each byte-equal to
      `_cdef_shard_core` on the same inputs, and the kernel's times on
      shard 0 of 2 (device, wrapper-inclusive, plain, the bound with
      both its terms);
   e. `Decoder(DecoderConfig(space_shards=2))` on the intra stream's TU
      0, with the card twice as the process's devices (the shard path,
      2 launches, each checked as in d) and with its own devices (one
      card: the fewer-devices warning and `cdef_frame`), against the
      manifest.

Every decode of phases 3-8 holds the scan kernel's launches equal to
the scans with lanes it ran, and the levels their counters report
complete equal to those scans' levels with lanes (`Launches`; in 7b
each GOP worker frame's `Decoder.stats` `scan_launches` and
`scan_levels`, in 7d each rank's, against the levels of the frame it
scanned): every scan ran on the kernel, to its last level; and the MC
kernel's launches equal to the MC passes with lanes, the residual
kernel's to the residual calls with blocks (a host frame's device
buckets, a device-path batch's residuals), the deblock kernel's to
one a device-path frame with a loop-filter level (in 7b and 7d through
the workers' `deblock_launches`), the superres kernel's to the
device-path frames with superres and the Wiener kernel's to those whose
Wiener LR ran on the device, with no plain MC pass, residual, deblock,
superres or Wiener call on the card.
The `launches` of the `{"kernels": [...]}` line count phases 3, 3b, 3c, 5,
6, 8a-c and 8e for `cdef_frame`, and phase 7's checked calls (counted
in each worker process: 4 ranks x 2 calls + 1 NCCL) and phase 8d-e
(2 + 4 + 2) for `cdef_filter` (17), and for `wavefront_scan` the
launches of every checked scan of phases 3-8 in this process (3, 3b, 3c,
4, 5 and 7a, 6, 8a-c, 8e; its times are phase 2's on the 1080p batch),
and for `mc`, `itx`, `deblock`, `superres` and `wiener` their launches
in every checked decode of phases 3-8 in this process (their times:
`mc` on the inter stream's frame 7, phase 5, `itx` on the host stream's
last host frame, phase 6, `deblock` on frame 0 of
`bench_1080p_intra_lf`, phase 3b (the other 1080p streams have no
loop-filter level: libaom chose level 0, but for `bench_1080p_intra_sres`),
`superres` on frame 0 of `bench_1080p_intra_sres`, phase 3c,
`wiener` on the cq-40 key frame, phase 8b).
`cdef_frame`'s times there are phase 2's (1080p 4:2:0, random all-tap
strengths); `cdef_filter`'s are those of its `Decoder`-path launch,
shard 0 of 2 in 8d (luma pad 1084x964, chroma pads 544x484), and its
max_abs_err is phase 8's (phases 2 and 7 raise on any).
Every device time from torch.profiler falls back, where every trace of
it lost records (the profiler at times starts recording late for a
whole series of traces), to CUDA events (`traced`, logged): a kernel's
around each of its launches behind a spin kernel (also in 7c's
workers), other calls' around the calls queued behind a spin kernel.
Prints that line, the card's name and power limit, and
as its last line `{"ok": true, "device": {...}}`.  Exits non-zero without
a result when no CUDA device is present.
"""
import itertools
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
BIG_LF = "bench_1080p_intra_lf"  # BIG at cq-level 55: every frame deblocks
BIG_INTER = "bench_1080p_inter"
BIG_HOST = "bench_1080p_host"
BIG_HOST40 = "bench_1080p_host_cq40"
BIG_COMPOUND = "bench_1080p_compound"
# BIG with superres at denominator 16: every frame upscales 960 -> 1920
BIG_SRES = "bench_1080p_intra_sres"
BIGS = (BIG, BIG_LF, BIG_SRES, BIG_INTER, BIG_HOST, BIG_HOST40,
        BIG_COMPOUND)
SCREEN = "screen"  # phase 8c: its TU 0 is an intra block copy key frame
SHARDS = (2, 4)  # phase 8d: in-process column shards of sharded CDEF
INTER_FRAMES = 7  # inter frames of BIG_INTER (after its key frame)
CHECKPOINT_TU = 4  # phase 7a saves the decode of BIG_INTER before it
GOP_TUS = 4  # phase 7b: the first TUs (one GOP each) of BIG
SCALE_RANKS = 4  # phase 7c-d: gloo ranks on the one card
N_SPACE = (2, 4)  # phase 7c: space shards of sharded CDEF
TIME_ITERS = 20  # phase 7c: timed sharded CDEF calls per rank
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
# subtract) to centre the pixels, 8 x 30 for the squares and weighted
# sums of the costs, 16 for the first maximum
DIR_OPS_PER_UNIT = 64 * 2 + 8 * 30 + 16
# int8 operations of its partial sums: 8 directions x 64 pixels, each a
# multiply-add (2 operations) on the tensor cores (the kernels' mma.sync)
DIR_INT8_OPS_PER_UNIT = 8 * 64 * 2
# H100 SXM data sheet: dense int8 tensor-core rate
INT8_OPS_PER_S = 1.979e15
# int32 operations of the wavefront scan per written pixel: the residual
# add and the clip (every lane), and by mode family its prediction:
# Paeth (3 add/sub, 3 abs, 3 sub, 2 compares, 2 selects), smooth (4
# multiplies, 4 add/sub, rounding add and shift; 2 + 3 one-sided),
# directional (position multiply, 2 shifts, add, 2 LUT reads, 2
# multiplies, add, rounding, compare), filter-intra (7 multiply-adds,
# rounding and clip), CfL on DC (4 luma reads, 3 adds, shift, subtract,
# multiply, rounding add and shift, add, clip); DC, V, H, palette and
# MF_INTER lanes predict with no operation a pixel
SCAN_OPS_PER_PX = 3
SCAN_FAMILY_OPS = {7: 13, 4: 10, 5: 5, 6: 5, 3: 12, 9: 18}
SCAN_CFL_OPS_PER_PX = 14
# phase 2: runs of the scan kernel on each checked batch, each
# byte-compared with the plain scan
SCAN_REPEATS = 50
# runs of the MC kernel on each checked pass and of the residual kernel
# on each checked call, each byte-compared with its plain version
MC_REPEATS = 10
ITX_REPEATS = 10
# B7's multi-CTA spans (phase 2): blocks a span (more than two CTAs of
# any size, a multiple of none), and their transform types: DCT, FLIPADST
# both ways, identity, and the 1-D types with a flip
SPAN_BLOCKS = 65
SPAN_TYPES = (0, 6, 9, 14, 15)
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


# cycles of the spin kernel `queued_ms` queues its calls behind (about
# 0.1 s at the H100's 1.98 GHz)
QUEUE_SPIN = 200_000_000


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


def _device_events(fn, iters, name=None):
    """torch.profiler's device intervals of `iters` warm calls of fn()
    from a trace that lost no record (`profiling.complete_events`: with
    `name`, it holds `iters` kernels whose name holds it; where no trace
    was whole, the last `iters` such kernels a trace kept and what
    followed them); a trace taken again, and such a fallback, are
    logged.  Raises when every trace lost records."""
    from av1dec_tpu_torch.profiling import complete_events
    ev, traces, whole = complete_events(fn, iters, name)
    if not whole:
        log(f"profiler: no whole trace of {iters} calls in {traces}; the "
            f"last {iters} {name} kernels of a trace that lost its first "
            f"marker, and what followed them")
    elif traces > 1:
        log(f"profiler: {traces} traces of {iters} calls for one whole "
            f"trace{f' of {name}' if name else ''}")
    return ev


def traced(fn, name, iters, one_each=True):
    """(ms of every device interval, kernels, ms of the kernels whose
    name holds `name`) per fn() call (no host cost counted), from one
    trace that lost no record: with `one_each` (fn launches one such
    kernel), one that holds `iters` of them, else one that kept as many
    events as an earlier trace (`_device_events`).  Where every trace
    lost records (`profiling.RecordsLost`: the profiler starts recording
    late, at times for a whole series of traces), both times are the
    calls' `queued_ms`, but the kernels' is `profiling.launch_ms` where
    fn launches kernels of this tree, and the kernels are not counted
    (None), logged."""
    from av1dec_tpu_torch import profiling
    try:
        ev = _device_events(fn, iters, name if one_each else None)
    except profiling.RecordsLost as e:
        calls = queued_ms(fn, iters)
        launched = profiling.launch_ms(fn, iters)
        log(f"profiler: {e}; {name} timed from CUDA events instead: "
            f"around each launch behind a spin kernel "
            f"{launched and launched[0]} ms a call, around {iters} calls "
            f"queued behind a spin kernel {calls} ms a call; kernels not "
            f"counted")
        return calls, None, calls if launched is None else launched[0]
    kernels = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]

    def ms(evs):
        return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters
    return ms(ev), len(kernels) / iters, ms(e for e in ev if name in e.name)


def queued_ms(fn, iters):
    """Mean device milliseconds of fn() a call from CUDA events around
    `iters` calls that the host queued behind a spin kernel (QUEUE_SPIN
    cycles, far longer than the host takes to queue them), so the card
    runs them back to back: no host cost, the gaps between kernels (a
    few microseconds) counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_ms(fn, name, iters):
    """Mean device milliseconds, per fn() call, of the kernels whose name
    holds `name` (no host cost counted); fn() launches one such kernel.
    Where every trace lost records, the calls' `queued_ms` (`traced`)."""
    return traced(fn, name, iters)[2]


def bound_terms(int_rate, nbytes, ops, int8_ops=0):
    """Both terms of the bound of work of `nbytes`, `ops` int32 operations
    and `int8_ops` on the tensor cores, the bound and what sets it."""
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = (ops / int_rate + int8_ops / INT8_OPS_PER_S) * 1e3
    b, by = (b_ops, "operations") if b_ops > b_bytes else (b_bytes, "bytes")
    return {"bytes": nbytes, "ops": ops, "int8_ops": int8_ops,
            "bytes_ms": b_bytes, "ops_ms": b_ops, "bound_ms": b,
            "bound_by": by}


def bound(int_rate, nbytes, ops, int8_ops=0):
    """(bound ms, what sets it) of the work of `bound_terms`."""
    t = bound_terms(int_rate, nbytes, ops, int8_ops)
    return t["bound_ms"], t["bound_by"]


def filter_ops(apply, pri_on, sec_on, px):
    """int32 operations of the filter: `px` pixels for each unit of the
    boolean per-unit tensors."""
    taps = 4 * pri_on.long() + 8 * sec_on.long()
    per_px = torch.where(apply, CDEF_OPS_PER_PX + CDEF_OPS_PER_TAP * taps,
                         torch.zeros_like(taps))
    return int(per_px.sum()) * px


def cdef_work(planes, gates, bd, subx, suby, pads=None):
    """(bytes, int32 operations, int8 operations) that CDEF of one frame,
    or of one column shard from its bordered planes `pads`, needs with
    these inputs: the planes (or the pads, which hold the shard's pixels)
    read once, the planes written once and the strengths read once; the
    direction search of each unit with a primary strength (its partial
    sums in int8), and the taps that are on in each unit with something
    to apply."""
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
    searched = int(search.sum())
    ops += searched * DIR_OPS_PER_UNIT
    nbytes = sum(4 * p.numel() for p in (planes if pads is None else pads))
    nbytes += sum(4 * p.numel() for p in planes) + \
        (4 if chroma else 2) * 4 * y_pri.numel()
    return nbytes, ops, searched * DIR_INT8_OPS_PER_UNIT


def shard_inputs(planes, gates, n, s):
    """`cdef_shard`'s inputs for column shard s of n of a whole frame:
    the bordered planes, as `cdef_local` builds them, and the shard's
    strengths."""
    from av1dec_tpu_torch.parallel.sharded_cdef import _local_pad
    pads = tuple(_local_pad(p, s, n) for p in planes)
    uw = gates[0].shape[1] // n
    return pads, [g[:, s * uw:(s + 1) * uw].contiguous() for g in gates]


def shard_work(planes, gates, bd, subx, suby, n, s):
    """`cdef_work` of column shard s of n of a whole frame."""
    pads, strengths = shard_inputs(planes, gates, n, s)
    return cdef_work(tuple(p[2:-2, 2:-2] for p in pads), strengths, bd,
                     subx, suby, pads)


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
    nbytes, ops, ops8 = cdef_work(planes, gates, bd, subx, suby)
    b, by = bound(int_rate, nbytes, ops, ops8)
    log(f"cdef_frame {what}: device {k:.4f} ms (wrapper-inclusive "
        f"{w:.4f} ms), plain {p:.4f} ms, bound {b:.4f} ms ({by}; "
        f"{nbytes} bytes, {ops} int32 ops, {ops8} int8 ops), "
        f"{b / k:.3f} of the bound")
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

    # the shard kernel: every shard of frames cut into 1, 2 and 4 column
    # shards (shard widths 160, 80, 40 and 960, 480: some not multiples
    # of 64), with the pads cdef_local builds and with random values in
    # their halo columns
    n = 0
    for fmt in FORMATS:
        for bd in (8, 10):
            for gates in GATES:
                planes, g, damping, sx, sy = frame_inputs(
                    rng, 72, 160, bd, fmt, gates, dev)
                for shards in (1, 2, 4):
                    for halo in (None, rng):
                        n += check_shards(
                            cdef, planes, g, bd, damping, sx, sy, shards,
                            f"72x160 {fmt} {bd}-bit {gates}", halo)
    for bd in (8, 10):
        for gates in ("mixed", "all_taps"):
            planes, g, damping, sx, sy = frame_inputs(
                rng, 1080, 1920, bd, "420", gates, dev)
            for shards in (2, 4):
                n += check_shards(cdef, planes, g, bd, damping, sx, sy,
                                  shards, f"1080x1920 420 {bd}-bit {gates}",
                                  rng if gates == "mixed" else None)
    log(f"kernel cdef_filter: byte-equal to _cdef_shard_core on {n} shards "
        f"(72x160 in 4 formats x 8/10-bit x {len(GATES)} strength kinds x "
        f"1/2/4 shards, 1080p 4:2:0 8/10-bit x 2/4 shards; halo columns "
        f"of the neighbours and random; one launch a shard; max abs err 0)")

    # times at 1080p 4:2:0: the frame kernel on random all-tap strengths
    planes, g, damping, sx, sy = frame_inputs(rng, 1080, 1920, 8, "420",
                                              "all_taps", dev)
    frame = time_frame(cdef, planes, g, 8, damping, sx, sy, int_rate,
                       "1080p 4:2:0 8-bit, random all-tap strengths")
    frame["max_abs_err"] = max_frame
    return frame


def check_shards(cdef, planes, gates, bd, damping, subx, suby, n, what,
                 halo_rng=None):
    """Every column shard of n of a frame: one `cdef_shard` launch, held
    byte-equal to `_cdef_shard_core` on the same inputs; with
    `halo_rng`, random values in every pad's halo columns first (a tap
    that reads CDEF_VERY_LARGE, or the wrong side, where a pad has a
    neighbour's pixel shows).  Returns the shards checked."""
    for s in range(n):
        pads, strengths = shard_inputs(planes, gates, n, s)
        if halo_rng is not None:
            for p in pads:
                for cols in (slice(0, 2), slice(-2, None)):
                    p[2:-2, cols] = torch.as_tensor(halo_rng.integers(
                        0, 1 << bd, (p.shape[0] - 4, 2)).astype(np.int32),
                        device=p.device)
        before = cdef.launches
        got = cdef.cdef_shard(pads, *strengths, bd, damping, subx, suby)
        ref = cdef._cdef_shard_core(pads, *strengths, bd, damping, subx,
                                    suby)
        err = max(int((a - b).abs().max()) for a, b in zip(got, ref))
        if err or len(got) != len(ref) or cdef.launches != before + 1:
            raise AssertionError(
                f"cdef_filter != plain at {what}, shard {s} of {n}"
                f"{', random halos' if halo_rng else ''}: max abs err "
                f"{err}, {len(got)} planes (plain {len(ref)}), launches "
                f"{cdef.launches - before}")
    return n


def scan_work(inputs):
    """(bytes, int32 operations, lanes, written pixels) that the scan of
    one batch (`to_torch_inputs`' dict) needs with these lanes: the lane
    rows read once; each lane's residual (if it has one), palette map
    (palette lanes) or MC prediction (MF_INTER lanes) read once, its
    pixels written once; the edge pixels its family reads (w + h + 1,
    directional 2 (w + h) + 1) and CfL's co-located luma; the
    operations of SCAN_OPS_PER_PX, SCAN_FAMILY_OPS and
    SCAN_CFL_OPS_PER_PX a pixel, DC's edge sums and the directional
    edge filter and upsampling (12 a pixel of both edges)."""
    from av1dec_tpu_torch.ops.kernels.wavefront import _F
    sub = 1 << (inputs["config"][2] + inputs["config"][3])
    res_elem = inputs["res"].element_size()
    nbytes = ops = lanes = px = 0
    for rows in inputs["packed"].values():
        r = rows.cpu().numpy().astype(np.int64)
        w, h, mf = r[:, _F["w"]], r[:, _F["h"]], r[:, _F["mode_family"]]
        wh = w * h
        cfl = (mf == 0) & (r[:, _F["cfl_maxx"]] > 0)
        intra = (mf != 8) & (mf != 10)
        edge = np.where(mf == 3, 2 * (w + h), w + h) + 1
        nbytes += 4 * (r.size + wh.sum() + (wh * (mf == 8)).sum() +
                       (wh * (mf == 10)).sum() + (edge * intra).sum() +
                       sub * (wh * cfl).sum())
        nbytes += res_elem * (wh * (r[:, _F["res_idx"]] >= 0)).sum()
        fam = np.zeros_like(mf)
        for m, k in SCAN_FAMILY_OPS.items():
            fam[mf == m] = k
        ops += ((SCAN_OPS_PER_PX + fam + SCAN_CFL_OPS_PER_PX * cfl) *
                wh).sum()
        ops += ((w + h) * (mf == 0)).sum() + (24 * (w + h) * (mf == 3)).sum()
        lanes += len(r)
        px += wh.sum()
    return int(nbytes), int(ops), int(lanes), int(px)


def scan_levels(inputs):
    """Levels with lanes of a batch: what the kernel's counters report
    complete after its launch."""
    return int((inputs["levels"][1] > 0).sum())


def mc_frame(inputs):
    """A batch's scan buffer after its MC pass, as `scan_batch` makes
    it."""
    from av1dec_tpu_torch.pipeline.device_recon import mc_into
    frame = torch.zeros(inputs["n"] + 1, dtype=torch.int32,
                        device=inputs["device"])
    for ref_flat, lanes, cfg in inputs["mc"]:
        mc_into(frame, ref_flat, lanes, cfg)
    return frame


def scan_args(inputs):
    return (inputs["packed"], inputs["res"], inputs["pal"],
            inputs["config"])


def check_scan(inputs, what, repeats=SCAN_REPEATS):
    """The batch's scan on the card, `scan_into` (the kernel, one launch
    per batch with lanes), `repeats` times from the same buffer after the
    MC pass, each run byte-equal to the plain `_scan_plain` on it and its
    counters reporting every level with lanes complete; returns its
    launches."""
    from av1dec_tpu_torch.ops.kernels import wavefront as wf
    base = mc_frame(inputs)
    ref = base.clone()
    wf._scan_plain(ref, *scan_args(inputs), inputs["windows"])
    levels = scan_levels(inputs)
    launched = 0
    for run in range(repeats):
        got = base.clone()
        before = wf.launches
        wf.scan_into(got, *scan_args(inputs), inputs["windows"],
                     inputs["levels"])
        launched += wf.launches - before
        torch.cuda.synchronize()
        err = int((got[:-1] - ref[:-1]).abs().max())
        done = wf.levels_completed() if levels else 0
        if err or launched != (run + 1) * (levels > 0) or done != levels:
            raise AssertionError(
                f"wavefront_scan != plain at {what}, run {run + 1} of "
                f"{repeats}: max abs err {err}, {launched} launches, "
                f"{done} of {levels} levels with lanes complete")
    return launched


def floor_ms(inputs, iters):
    """Device ms of `wavefront_scan_floor` on the batch's tickets (its
    kernel interval): the same launch, tickets, waits and publishes as
    the scan with no pixel work, the chain term of its bound.  Raises
    unless its counters report every level with lanes complete."""
    from av1dec_tpu_torch.ops.kernels import wavefront as wf
    frame = mc_frame(inputs)
    out = []

    def run():
        out.append(wf._launch("wavefront_scan_floor", frame,
                              *scan_args(inputs), inputs["levels"]))
    ms = kernel_ms(run, "wavefront_floor_kernel", iters)
    torch.cuda.synchronize()
    if wf.levels_completed(out[-1]) != scan_levels(inputs):
        raise AssertionError("wavefront_scan_floor left levels incomplete")
    return ms


def time_scan(inputs, int_rate, what, iters=20):
    """The scan kernel's device ms (its kernel interval, no host cost),
    its wrapper-inclusive ms (CUDA events around `scan_into` calls), the
    plain version's ms on the same inputs, and the bound (bytes and
    operations, and the chain term: `floor_ms`); logged and returned as
    a dict."""
    from av1dec_tpu_torch.ops.kernels import wavefront as wf
    frame = mc_frame(inputs)
    levels = scan_levels(inputs)

    def run():
        wf.scan_into(frame, *scan_args(inputs), inputs["windows"],
                     inputs["levels"])
    before = wf.launches
    run()
    per_scan = wf.launches - before
    k = kernel_ms(run, "wavefront_scan_kernel", iters)
    w = cuda_ms(run, iters)
    floor = floor_ms(inputs, iters)
    plain = frame.clone()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    wf._scan_plain(plain, *scan_args(inputs), inputs["windows"])
    b.record()
    torch.cuda.synchronize()
    p = a.elapsed_time(b)
    nbytes, ops, lanes, px = scan_work(inputs)
    terms = bound_terms(int_rate, nbytes, ops)
    out = {"what": what, "levels": levels, "lanes": lanes, "pixels": px,
           "device_ms": k, "launches_per_scan": per_scan,
           "ms_per_level": k / levels, "wrapper_ms": w, "plain_ms": p,
           **terms, "chain_ms": floor, "link_ms": floor / levels,
           "share_of_bound": terms["bound_ms"] / k,
           "share_of_chain": floor / k, "card": card_line()}
    log(json.dumps({"scan_kernel": out}))
    return out


def phase_scan(manifest, dev, int_rate):
    """2 (scan): the scan kernel against its plain version on the card,
    byte-equal, on the first 4-frame batch of BIG, on every small
    stream's first batch (up to 4 frames without inter lanes) and first
    frame with MF_INTER lanes (each as `Decoder(device="cuda")` gives
    it), and on BIG_INTER's first inter frame; then its times on BIG's
    batch and on that inter frame.  Each of these batches whose levels
    went up also holds `itx.cu`'s residuals, the scan's buffer, to the
    plain route on the card (`_residuals_plain` on the same packed
    levels, descriptors and scattered `out` offsets), byte-equal on
    every word the blocks cover.  Returns BIG's times, with
    "itx_batches" and "itx_max_abs_err" of the residual checks."""
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.config import DecoderConfig
    from av1dec_tpu_torch.ops.kernels import itx
    from av1dec_tpu_torch.pipeline.device_recon import (batch_residuals,
                                                        prep_batch,
                                                        to_torch_inputs)
    from av1dec_tpu_torch.pipeline.wavefront import MF_INTER
    itx_errs = []

    def inputs_of(drs, what):
        # the residuals computed once, so that each run is the scan's
        inputs = to_torch_inputs(prep_batch(drs), dev)
        inputs["res"] = batch_residuals(inputs)
        if inputs["res_levels"] is not None:
            plain = itx._residuals_plain(*inputs["res_levels"])
            rf = inputs["res_levels"][2] // len(drs)
            cover = torch.cat([torch.arange(f * rf, f * rf + dr._res_px_tot,
                                            device=dev)
                               for f, dr in enumerate(drs)])
            err = int((inputs["res"][cover].long() -
                       plain[cover].long()).abs().max()) if len(cover) else 0
            itx_errs.append(err)
            if err:
                raise AssertionError(f"itx on {what}'s residuals: the "
                                     f"kernel != the plain route on the "
                                     f"card, max abs err {err}")
        return inputs

    def has_inter_lanes(dr):
        return any((bc.packed["mode_family"] == MF_INTER).any()
                   for bc in dr.sch.classes.values())

    def captured(name, tus):
        kept = []
        real = api.DeviceRecon

        class Keep(real):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                kept.append(self)
        api.DeviceRecon = Keep
        try:
            dec = api.Decoder(DecoderConfig(apply_grain=False), device=dev)
            for tu in tus:
                dec.decode(tu)
            dec.close()
        finally:
            api.DeviceRecon = real
        return [dr for dr in kept if dr.supported()]

    parser = NativeParser()
    big = []
    for tu in read_tus(BIG)[:4]:
        for hdr, plans in parser.parse_tu(tu, with_plans=True):
            big.append(api.DeviceRecon(parser.seq, hdr, plans))
    parser.close()
    big_inputs = inputs_of(big, f"{BIG} frames 0-3")
    if not itx_errs:
        raise AssertionError(f"{BIG} frames 0-3 took the NumPy residuals")
    launches = check_scan(big_inputs, f"{BIG} frames 0-3")
    n = 1
    seen = set()
    for name in sorted(m for m in manifest if m not in BIGS):
        drs = captured(name, read_tus(name))
        intra = [dr for dr in drs if dr._inter_plan is None][:4]
        inter = next((dr for dr in drs if has_inter_lanes(dr)), None)
        for batch in ([intra] if intra else []) + \
                ([[inter]] if inter else []):
            what = f"{name} frames {[drs.index(d) for d in batch]}"
            launches += check_scan(inputs_of(batch, what), what)
            n += 1
            sch = batch[0].sch
            fmt = "mono" if sch.num_planes == 1 else \
                {(1, 1): "420", (1, 0): "422", (0, 0): "444"}[
                    (sch.sub_x, sch.sub_y)]
            seen.add((sch.bd, fmt, batch[0]._inter_plan is not None))
    inter_dr = next(dr for dr in captured(BIG_INTER, read_tus(BIG_INTER)[:2])
                    if has_inter_lanes(dr))
    n_itx = len(itx_errs)
    inter_inputs = inputs_of([inter_dr], f"{BIG_INTER} frame 1")
    if len(itx_errs) == n_itx:
        raise AssertionError(f"{BIG_INTER} frame 1 took the NumPy "
                             f"residuals")
    launches += check_scan(inter_inputs, f"{BIG_INTER} frame 1")
    n += 1
    bds = {b for b, _, _ in seen}
    fmts = {f for _, f, _ in seen}
    if not ({8, 10} <= bds and {"420", "444", "mono"} <= fmts and
            any(i for _, _, i in seen)):
        raise AssertionError(f"scan checks cover bit depths {bds}, formats "
                             f"{fmts}, MF_INTER batches "
                             f"{any(i for _, _, i in seen)}")
    log(f"kernel wavefront_scan: byte-equal to the plain scan on {n} "
        f"batches, {SCAN_REPEATS} runs each ({BIG} frames 0-3, "
        f"{BIG_INTER} frame 1, every small stream's first batch and first "
        f"frame with MF_INTER lanes; {sorted(bds)}-bit, {sorted(fmts)}); "
        f"{launches} launches, one a run, each run's counters reporting "
        f"every level with lanes complete; max abs err 0")
    log(f"kernel itx: the device path's residuals byte-equal to the plain "
        f"route on the card on {len(itx_errs)} of these batches (those "
        f"without a quantizer matrix or lossless block; {BIG} frames 0-3 "
        f"and {BIG_INTER} frame 1 among them), every word the blocks "
        f"cover; max abs err {max(itx_errs)}")
    out = time_scan(big_inputs, int_rate, f"{BIG} frames 0-3")
    time_scan(inter_inputs, int_rate, f"{BIG_INTER} frame 1")
    out["max_abs_err"] = 0
    out["itx_batches"] = len(itx_errs)
    out["itx_max_abs_err"] = max(itx_errs)
    return out


# each checked `Launches` block's launches of the scan, MC, residual,
# deblock, superres and Wiener kernels, in order: their launches on the
# main paths
MAIN_SCANS = []
MAIN_MC = []
MAIN_ITX = []
MAIN_DEBLOCK = []
MAIN_SUPERRES = []
MAIN_WIENER = []
# deblock kernel launches a frame: both passes of every plane in one
DEBLOCK_PER_FRAME = 1


def on_card(x):
    """Whether a tensor, or the first tensor of a list or tuple, is on a
    card."""
    while isinstance(x, (list, tuple)):
        x = x[0]
    return x.is_cuda


class Launches:
    """Inside `with`: counts the scans that go through
    `device_recon.scan_into`, those with lanes and their levels with
    lanes (from the lanes each is given), keeping each launch's counter
    buffer; the MC passes that go through `device_recon.mc_into` with
    lanes; the `recon.residuals_packed` calls with blocks (a host frame's
    device buckets, a device-path batch's residuals); the postfilter
    calls on a card that go through
    `device_recon.deblock_planes`, `superres_planes` and
    `lr_wiener_planes` (with a Wiener plane); and the calls of the plain
    MC pass, residuals, deblock, superres and Wiener on a card.  On
    leaving, holds the scan kernel's launches (`wavefront.launches`, set
    to 0 on entry) equal to the scans with lanes and the levels their
    counters report complete equal to those levels, the MC kernel's
    (`mc.launches`) equal to the passes with lanes, the residual
    kernel's (`itx.launches`) equal to the calls with blocks, the
    deblock kernel's to DEBLOCK_PER_FRAME a deblock call, the superres
    and Wiener kernels' to their calls, and no plain call on the card:
    every scan, MC pass, residual and postfilter call ran on its kernel."""

    def __init__(self, what):
        self.what = what
        self.levels = self.scans = self.with_lanes = 0
        self.passes = self.residual_calls = self.plain_on_card = 0
        self.deblocks = self.upscales = self.wieners = 0
        self.counters = []

    def __enter__(self):
        from av1dec_tpu_torch.ops.kernels import (deblock, itx, lr, mc,
                                                  superres, wavefront)
        from av1dec_tpu_torch.pipeline import device_recon, recon
        self.real = {(device_recon, "scan_into"): device_recon.scan_into,
                     (device_recon, "mc_into"): device_recon.mc_into,
                     (recon, "residuals_packed"): recon.residuals_packed,
                     (device_recon, "deblock_planes"):
                     device_recon.deblock_planes,
                     (device_recon, "superres_planes"):
                     device_recon.superres_planes,
                     (device_recon, "lr_wiener_planes"):
                     device_recon.lr_wiener_planes,
                     (mc, "_mc_plain"): mc._mc_plain,
                     (itx, "_residuals_plain"): itx._residuals_plain,
                     (deblock, "_deblock_plain"): deblock._deblock_plain,
                     (superres, "_superres_plain"):
                     superres._superres_plain,
                     (lr, "_wiener_plain"): lr._wiener_plain}
        real = {name: fn for (_, name), fn in self.real.items()}

        def scan_into(*args):
            levels = int((args[6][1] > 0).sum())
            self.levels += levels
            self.scans += 1
            self.with_lanes += levels > 0
            before = wavefront.launches
            out = real["scan_into"](*args)
            if wavefront.launches > before:
                self.counters.append(wavefront.last_scan)
            return out

        def mc_into(*args):
            self.passes += any(n for _, _, n in args[3][0])
            return real["mc_into"](*args)

        def residuals_packed(*args):
            self.residual_calls += sum(s[3] for s in args[1]) > 0
            return real["residuals_packed"](*args)

        def deblock_planes(*args):
            self.deblocks += on_card(args[0])
            return real["deblock_planes"](*args)

        def superres_planes(*args):
            self.upscales += on_card(args[0])
            return real["superres_planes"](*args)

        def lr_wiener_planes(*args):
            self.wieners += on_card(args[0]) and \
                any(a is not None for a in args[2])
            return real["lr_wiener_planes"](*args)

        def plain(name):
            def call(*args):
                self.plain_on_card += on_card(args[0])
                return real[name](*args)
            return call
        for (mod, name), fn in zip(self.real, (
                scan_into, mc_into, residuals_packed, deblock_planes,
                superres_planes, lr_wiener_planes, plain("_mc_plain"),
                plain("_residuals_plain"), plain("_deblock_plain"),
                plain("_superres_plain"), plain("_wiener_plain"))):
            setattr(mod, name, fn)
        wavefront.launches = mc.launches = itx.launches = 0
        deblock.launches = superres.launches = lr.launches = 0
        return self

    def __exit__(self, kind, *_):
        from av1dec_tpu_torch.ops.kernels import (deblock, itx, lr, mc,
                                                  superres, wavefront)
        for (mod, name), fn in self.real.items():
            setattr(mod, name, fn)
        if kind is None:
            torch.cuda.synchronize()
            done = sum(map(wavefront.levels_completed, self.counters))
            if wavefront.launches != self.with_lanes or \
                    done != self.levels:
                raise AssertionError(
                    f"{self.what}: wavefront_scan launches "
                    f"{wavefront.launches} != {self.with_lanes} scans with "
                    f"lanes of {self.scans}, or levels complete {done} != "
                    f"{self.levels} levels with lanes")
            if mc.launches != self.passes or \
                    itx.launches != self.residual_calls or \
                    self.plain_on_card:
                raise AssertionError(
                    f"{self.what}: mc launches {mc.launches} != "
                    f"{self.passes} MC passes with lanes, or itx launches "
                    f"{itx.launches} != {self.residual_calls} residual "
                    f"calls with blocks, or {self.plain_on_card} plain "
                    f"MC, residual, deblock, superres or Wiener calls on "
                    f"the card")
            if deblock.launches != DEBLOCK_PER_FRAME * self.deblocks or \
                    superres.launches != self.upscales or \
                    lr.launches != self.wieners:
                raise AssertionError(
                    f"{self.what}: deblock launches {deblock.launches} != "
                    f"{DEBLOCK_PER_FRAME} x {self.deblocks} frames with a "
                    f"loop-filter level, or superres launches "
                    f"{superres.launches} != {self.upscales} frames with "
                    f"superres, or wiener launches {lr.launches} != "
                    f"{self.wieners} frames with device Wiener LR")
            MAIN_SCANS.append(wavefront.launches)
            MAIN_MC.append(mc.launches)
            MAIN_ITX.append(itx.launches)
            MAIN_DEBLOCK.append(deblock.launches)
            MAIN_SUPERRES.append(superres.launches)
            MAIN_WIENER.append(lr.launches)
        return False

    def __str__(self):
        return (f"wavefront_scan launches {self.with_lanes} = scans with "
                f"lanes of {self.scans}, their counters reporting all "
                f"{self.levels} levels with lanes complete; mc launches "
                f"{self.passes} = MC passes with lanes; itx launches "
                f"{self.residual_calls} = residual calls with blocks; "
                f"deblock launches {DEBLOCK_PER_FRAME * self.deblocks} = "
                f"{DEBLOCK_PER_FRAME} x {self.deblocks} device frames with "
                f"a loop-filter level; superres launches {self.upscales} "
                f"= device frames with superres; wiener launches "
                f"{self.wieners} = device frames with Wiener LR; no plain "
                f"MC, residual, deblock, superres or Wiener call on the "
                f"card")


def frame_levels(name, count):
    """Levels with lanes of the scan of each of the first `count` coded
    frames of an all-intra stream, each scanned alone (host prep)."""
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.ops.kernels.wavefront import plan_levels
    from av1dec_tpu_torch.pipeline.device_recon import (DeviceRecon,
                                                        prep_batch)
    parser = NativeParser()
    out = []
    for tu in read_tus(name)[:count]:
        for hdr, plans in parser.parse_tu(tu, with_plans=True):
            prep = prep_batch([DeviceRecon(parser.seq, hdr, plans)])
            ts = [t for t, _ in prep["buckets"]]
            inp = prep["inputs_np"]
            _, lanes, _ = plan_levels({t: inp[t][1] for t in ts},
                                      {t: inp[t][2] for t in ts}, ts)
            out.append(int((lanes > 0).sum()))
    parser.close()
    return out


def deblock_frames(name, count):
    """Whether each of the first `count` coded frames of a stream has a
    loop-filter level (host maps)."""
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.ops.spec.deblock import build_deblock_maps
    parser = NativeParser()
    out = []
    for tu in read_tus(name)[:count]:
        for hdr, plans in parser.parse_tu(tu, with_plans=True):
            seq = parser.seq
            planes = 1 if seq["mono_chrome"] else 3
            out.append(build_deblock_maps(seq, hdr, plans, planes)
                       is not None)
    parser.close()
    return out


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
    shard kernel."""
    if cdef.frame_launches != n_cdef or cdef.launches != 0:
        raise AssertionError(
            f"{what}: cdef_frame launches {cdef.frame_launches} != "
            f"{n_cdef} frames with CDEF on, or cdef_filter launches "
            f"{cdef.launches} != 0")


def postfilter_clocked(decode):
    """decode() with host ms around each `postfilter_batch` call, the
    device synchronised before and after it.  Returns (what decode()
    returns, mean postfilter ms a frame)."""
    from av1dec_tpu_torch.pipeline import device_recon
    spent = []
    real = device_recon.postfilter_batch

    def clocked(drs, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(drs, *args)
        torch.cuda.synchronize()
        spent.append(((time.perf_counter() - t) * 1e3, len(drs)))
        return out
    device_recon.postfilter_batch = clocked
    try:
        out = decode()
    finally:
        device_recon.postfilter_batch = real
    return out, sum(ms for ms, _ in spent) / sum(n for _, n in spent)


def phase_main_path(manifest, dev, int_rate):
    """3; returns the `cdef_frame` launches of the checked pass and frame
    0's CDEF inputs."""
    from av1dec_tpu_torch.api import STAGES, decode_stream_batched
    from av1dec_tpu_torch.api import display_md5
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.ops.kernels import cdef
    datas = [d for _, d in read_ivf(os.path.join(TESTDATA, BIG + ".ivf"))]
    want = manifest[BIG]["frames"]
    n_cdef = cdef_frames(datas)

    cdef.launches = cdef.frame_launches = 0
    t0 = time.perf_counter()
    with Launches("main path") as scans:
        out = decode_stream_batched(datas, device=dev, batch=4)
    t_first = time.perf_counter() - t0
    launches = cdef.frame_launches
    check_launches(cdef, n_cdef, "main path")
    if launches == 0:
        raise AssertionError("main path: no frame with CDEF on")
    if scans.levels == 0:
        raise AssertionError("main path: no wavefront_scan launch")
    got = [display_md5(p, 8, 1920, 1080, (1, 1)) for p in out]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        raise AssertionError(f"1080p frames differ from the manifest: "
                             f"{bad} of {len(want)}")
    log(f"main path: {len(got)}/{len(want)} frames of {BIG} match the "
        f"manifest; cdef_frame launches {launches} = {n_cdef} frames with "
        f"CDEF on, cdef_filter launches 0; {scans}; the scan ran under "
        f"sync debug mode 'error' (no device->host sync); first pass "
        f"{t_first:.3f} s")

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
    return launches, seen[0]


def device_stream(manifest, name, dev, label):
    """`decode_stream_batched(device="cuda", batch=4)` on the 1080p stream
    `name`: every frame's MD5 against the manifest, every frame on the
    device path (no host-path frame), one `cdef_frame` launch per frame
    with CDEF on, the other kernels' launches held by `Launches`; then a
    timed pass (`fps_<label>`, per-stage ms).  Returns the `cdef_frame`
    launches of the checked pass and its `Launches` block."""
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.pipeline.recon import FrameRecon
    datas = read_tus(name)
    want = manifest[name]["frames"]
    n_cdef = cdef_frames(datas)
    host = []
    real_run = FrameRecon.run

    def run(self):
        host.append(1)
        return real_run(self)
    cdef.launches = cdef.frame_launches = 0
    FrameRecon.run = run
    t0 = time.perf_counter()
    try:
        with Launches(name) as scans:
            out = api.decode_stream_batched(datas, device=dev, batch=4)
    finally:
        FrameRecon.run = real_run
    t_first = time.perf_counter() - t0
    launches = cdef.frame_launches
    check_launches(cdef, n_cdef, name)
    got = [api.display_md5(p, 8, 1920, 1080, (1, 1)) for p in out]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad or host:
        raise AssertionError(f"{name}: frames {bad} of {len(want)} differ "
                             f"from the manifest, {len(host)} on the host "
                             f"path")
    log(f"{label} stream: {len(got)}/{len(want)} frames of {name} match "
        f"the manifest, all on the device path; cdef_frame launches "
        f"{launches} = {n_cdef} frames with CDEF on; {scans}; first pass "
        f"{t_first:.3f} s")
    t0 = time.perf_counter()
    api.decode_stream_batched(datas, device=dev, batch=4)
    dt = time.perf_counter() - t0
    tm = {}
    api.decode_stream_batched(datas, device=dev, batch=4, timings=tm)
    log(json.dumps({f"fps_{label}": len(datas) / dt, "seconds": dt,
                    "frames": len(datas), "stage_ms_per_frame": {
                        k: round(tm[k] * 1e3 / len(datas), 3)
                        for k in api.STAGES}, "card": card_line()}))
    return launches, scans


def first_call(name, dev, fn_name):
    """The arguments of the first `device_recon.<fn_name>` call of the
    decode of the 1080p stream `name`'s first TU on the card, as the
    chain gives them; that frame held to the manifest."""
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.pipeline import device_recon
    with open(os.path.join(TESTDATA, "manifest.json")) as f:
        want = json.load(f)[name]["frames"][:1]
    seen = []
    real = getattr(device_recon, fn_name)

    def keep(*args):
        seen.append(args)
        return real(*args)
    setattr(device_recon, fn_name, keep)
    try:
        out = api.decode_stream_batched(read_tus(name)[:1], device=dev,
                                        batch=1)
    finally:
        setattr(device_recon, fn_name, real)
    got = [api.display_md5(p, 8, 1920, 1080, (1, 1)) for p in out]
    if got != want or not seen:
        raise AssertionError(f"{name} frame 0: equal to the manifest "
                             f"{got == want}, {fn_name} calls {len(seen)}")
    return seen[0]


def phase_lf_stream(manifest, dev, int_rate):
    """3b: `device_stream` on BIG_LF, whose every frame has a loop-filter
    level, each frame with one deblock launch; then the deblock kernel on
    frame 0's own planes and maps, byte-equal to `_deblock_plain`
    POST_REPEATS runs, and its times.  Returns the `cdef_frame` launches
    of the checked pass and the deblock kernel's entry."""
    from av1dec_tpu_torch.ops.kernels import deblock
    with_lf = deblock_frames(BIG_LF, len(read_tus(BIG_LF)))
    if not all(with_lf):
        raise AssertionError(f"{BIG_LF}: frames without a loop-filter "
                             f"level: {with_lf}")
    launches, scans = device_stream(manifest, BIG_LF, dev, "1080p_intra_lf")
    if scans.deblocks != len(with_lf):
        raise AssertionError(f"{BIG_LF}: {scans.deblocks} frames deblocked "
                             f"on the card of {len(with_lf)}")
    args = first_call(BIG_LF, dev, "deblock_planes")
    what = f"{BIG_LF} frame 0 (its planes and maps)"
    dbl = (deblock.deblock_planes, deblock._deblock_plain)
    check_post("deblock", *dbl, deblock, args, what, DEBLOCK_PER_FRAME)
    log(f"kernel deblock: byte-equal to _deblock_plain on {what}, "
        f"{POST_REPEATS} runs, one launch each; max abs err 0")
    return launches, time_post("deblock", *dbl, args, deblock_work(*args),
                               int_rate, what)


def phase_sres_stream(manifest, dev, int_rate):
    """3c: `device_stream` on BIG_SRES, whose every frame is coded 960
    wide and upscaled to 1920 (superres at denominator 16), each frame
    with exactly one superres launch; then the superres kernel on frame
    0's own planes and tables, byte-equal to `_superres_plain`
    POST_REPEATS runs, and its times.  Returns the `cdef_frame` launches
    of the checked pass and the superres kernel's entry."""
    from av1dec_tpu_torch.ops.kernels import superres
    frames = len(manifest[BIG_SRES]["frames"])
    launches, scans = device_stream(manifest, BIG_SRES, dev,
                                    "1080p_intra_sres")
    if scans.upscales != frames:
        raise AssertionError(f"{BIG_SRES}: {scans.upscales} frames upscaled "
                             f"on the card of {frames}")
    args = first_call(BIG_SRES, dev, "superres_planes")
    what = (f"{BIG_SRES} frame 0 (its {len(args[0])} planes, "
            f"{args[0][0].shape[1]} -> {args[1][0][0].shape[0]} columns)")
    sr = (superres.superres_planes, superres._superres_plain)
    check_post("superres", *sr, superres, args, what)
    log(f"kernel superres: byte-equal to _superres_plain on {what}, "
        f"{POST_REPEATS} runs, one launch each; max abs err 0")
    return launches, time_post(
        "superres", *sr, args, superres_work(args[0], args[1], sr[1](*args)),
        int_rate, what)


def phase_entry_point(manifest, dev):
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.ops.kernels import cdef
    names = sorted(n for n in manifest if n not in BIGS)
    n_cdef = n_host = 0
    cdef.launches = cdef.frame_launches = 0
    with Launches("small streams") as scans:
        for name in names:
            dec = Decoder(DecoderConfig(), device=dev)
            got = []
            datas = [tu for _, tu in read_ivf(
                os.path.join(TESTDATA, name + ".ivf"))]
            for tu in datas:
                got += [f.display_md5() for f in dec.decode(tu)]
            dec.close()
            n_cdef += cdef_frames(datas)
            if got != manifest[name]["frames"]:
                raise AssertionError(f"{name}: Decoder(device='cuda') "
                                     f"frames differ from the manifest")
            paths = [s["recon_path"] for s in dec.stats]
            if paths != manifest[name].get("paths",
                                           ["device"] * len(paths)):
                raise AssertionError(f"{name}: recon paths {paths} differ "
                                     f"from the manifest's")
            n_host += paths.count("host")
    check_launches(cdef, n_cdef, "small streams")
    log(f"entry point: Decoder(device='cuda') matches the manifest (film "
        f"grain applied) on {len(names)} streams: {' '.join(names)}; "
        f"{n_host} frames on the host pixel path; cdef_frame launches "
        f"{n_cdef} = frames with CDEF on, cdef_filter launches 0; {scans}")


def mc_work(ref_flat, lanes, cfg):
    """(bytes, int32 operations, lanes, predicted pixels) of one MC pass:
    each predicted pixel's reference read per list and its frame write,
    the lane rows read once; the 8-tap multiply-adds of the horizontal
    pass ((h + 7) x w a list) and the vertical pass (h x w a list)."""
    from av1dec_tpu_torch.ops.kernels.mc import _MF
    nbytes = ops = n_lanes = px = 0
    for (T, comp, _n) in cfg[0]:
        rows = lanes[(T, comp)].cpu().long()
        w, h = rows[:, _MF["w"]], rows[:, _MF["h"]]
        lists = 1 + comp
        px += int((w * h).sum())
        nbytes += int((w * h).sum()) * (lists * ref_flat.element_size() + 4)
        nbytes += rows.numel() * 4
        ops += lists * 8 * int((w * (2 * h + 7)).sum())
        n_lanes += rows.shape[0]
    return nbytes, ops, n_lanes, px


def lanes_disjoint(lanes, what):
    """Raises unless no two MC lanes write the same pixel: the kernel's
    blocks run in no order."""
    from torch_port_helpers import mc_lane_pixels
    px = mc_lane_pixels(lanes)
    if len(np.unique(px)) != len(px):
        raise AssertionError(f"{what}: MC lanes write a pixel twice")


def check_mc(frame, ref_flat, lanes, cfg, what, repeats=MC_REPEATS):
    """`mc_into` on the card (the kernel, one launch a pass) `repeats`
    times from the same buffer, each run byte-equal to the plain
    `_mc_plain` on it and the trash slot unwritten; returns its
    launches."""
    from av1dec_tpu_torch.ops.kernels import mc
    ref = frame.clone()
    mc._mc_plain(ref, ref_flat, lanes, cfg)
    launched = 0
    for run in range(repeats):
        got = frame.clone()
        before = mc.launches
        mc.mc_into(got, ref_flat, lanes, cfg)
        launched += mc.launches - before
        torch.cuda.synchronize()
        err = int((got[:-1] - ref[:-1]).abs().max())
        if err or launched != run + 1 or int(got[-1]) != int(frame[-1]):
            raise AssertionError(
                f"mc kernel != plain at {what}, run {run + 1} of {repeats}: "
                f"max abs err {err}, {launched} launches, trash slot "
                f"{int(got[-1])} (was {int(frame[-1])})")
    return launched


def phase_mc(dev):
    """2 (MC): the MC kernel against `_mc_plain` on the card, byte-equal,
    MC_REPEATS runs each, on seeded lanes of every T from 4 to 128,
    single-list, average and distance-weighted compound, motion vectors
    past every edge of the reference and partial w x h windows, at 8
    bits (uint8 and int32 references), 10 and 12 bits, in small
    reference pieces and in pieces larger than any window.  (The real
    lanes of BIG_INTER's frame 7 and of BIG_COMPOUND's last compound
    frame are checked where their decodes capture them, phases 5 and
    8a.)"""
    from torch_port_helpers import LARGE_PIECES, seeded_mc_lanes
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    launches = n = 0
    # small pieces (seed 100 + bd) and pieces larger than any window (seed
    # 400 + bd), as tests/test_torch_mc.py
    for (bd, dt), (seed, kw) in itertools.product(
            ((8, torch.uint8), (8, torch.int32), (10, torch.int32),
             (12, torch.int32)), ((100, {}), (400, LARGE_PIECES))):
        frame0, pieces, lanes = seeded_mc_lanes(
            bd, np.random.default_rng(seed + bd), **kw)
        cfg, rows = upload_lanes(lanes, bd, dev)
        if len(cfg[0]) != 12:
            raise AssertionError(f"seeded lanes fill {len(cfg[0])} buckets")
        lanes_disjoint(rows, f"seeded lanes, {bd}-bit")
        frame = torch.as_tensor(np.append(frame0, -7).astype(np.int32),
                                device=dev)
        launches += check_mc(frame, pack_ref_flat(pieces, dev).to(dt), rows,
                             cfg, f"seeded lanes, {bd}-bit, {dt} reference")
        n += sum(b[2] for b in cfg[0])
    log(f"kernel mc: byte-equal to _mc_plain on {n} seeded lanes (every T "
        f"4-128, single, average and distance-weighted compound, past "
        f"every edge, partial windows, in small and in large reference "
        f"pieces; 8-bit uint8 and int32 references, 10 and 12 bits), "
        f"{MC_REPEATS} runs each; {launches} launches, one a run; the "
        f"trash slot never written; max abs err 0")


def time_mc(frame, ref_flat, lanes, cfg, int_rate):
    """The MC kernel on one pass: every device interval and kernel of an
    `mc_into` call, its kernel interval, its wrapper-inclusive ms, the
    plain version's ms on the same inputs and the bound."""
    from av1dec_tpu_torch.ops.kernels import mc

    def run():
        mc.mc_into(frame, ref_flat, lanes, cfg)
    d_ms, n_k, k = traced(run, "mc_kernel", 20)
    nbytes, ops, n_lanes, px = mc_work(ref_flat, lanes, cfg)
    terms = bound_terms(int_rate, nbytes, ops)
    return {"lanes": n_lanes, "pixels": px, "buckets": len(cfg[0]),
            "device_ms": d_ms, "kernels": n_k, "kernel_ms": k,
            "wrapper_ms": cuda_ms(run, 20),
            "plain_ms": cuda_ms(lambda: mc._mc_plain(frame, ref_flat, lanes,
                                                     cfg), 5),
            **terms, "share_of_bound": terms["bound_ms"] / k,
            "card": card_line()}


def phase_inter(manifest, dev, int_rate):
    """5 (with 7a); returns the `cdef_frame` launches of the checked pass
    and the MC kernel's entry: its times on the last inter frame."""
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.pipeline import device_recon
    datas = [d for _, d in read_ivf(os.path.join(TESTDATA,
                                                 BIG_INTER + ".ivf"))]
    want = manifest[BIG_INTER]["frames"]
    n_cdef = cdef_frames(datas)

    saved = {}

    def decode(save_at=None):
        dec = Decoder(DecoderConfig(apply_grain=False), device=dev)
        md5s = []
        for i, tu in enumerate(datas):
            if i == save_at:
                t = time.perf_counter()
                saved["blob"] = dec.save_state()
                saved["save_ms"] = (time.perf_counter() - t) * 1e3
            md5s += [f.display_md5() for f in dec.decode(tu)]
        dec.close()
        return md5s, dec.stats

    cdef.launches = cdef.frame_launches = 0
    t0 = time.perf_counter()
    with Launches("inter path") as scans:
        got, stats = decode(save_at=CHECKPOINT_TU)
    t_first = time.perf_counter() - t0
    launches = cdef.frame_launches
    check_launches(cdef, n_cdef, "inter path")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{BIG_INTER} frames differ from the "
                             f"manifest: {bad} of {len(want)}")
    inter = [s for s in stats if not s["intra"]]
    on_dev = [s for s in inter if s["recon_path"] == "device"]
    if len(inter) != INTER_FRAMES or len(on_dev) != INTER_FRAMES:
        raise AssertionError(f"{len(on_dev)} of {len(inter)} inter frames "
                             f"on the device path, {INTER_FRAMES} expected")
    # every device-path frame's residuals from its levels, on the card
    routes = [s["residual_blocks"] for s in stats
              if s["recon_path"] == "device"]
    if any(r["numpy"] or not r["card"] for r in routes):
        raise AssertionError(f"{BIG_INTER}: residual blocks by route "
                             f"{routes}, all on the card expected")
    log(f"inter path: {len(got)}/{len(want)} frames of {BIG_INTER} match "
        f"the manifest; {len(on_dev)}/{len(inter)} inter frames on the "
        f"device path (MC pass and scan under sync debug mode 'error'); "
        f"residual blocks on the card {[r['card'] for r in routes]}, "
        f"NumPy 0; "
        f"cdef_frame launches {launches} = {n_cdef} frames with CDEF on, "
        f"cdef_filter launches 0; {scans}; first pass {t_first:.3f} s")
    with Launches("checkpoint resume"):
        phase_checkpoint(datas, want, saved, dev)

    t0 = time.perf_counter()
    _, stats = decode()
    dt = time.perf_counter() - t0

    def mean(key, intra):
        v = [s[key] for s in stats if s["intra"] == intra]
        return sum(v) / len(v)
    log(json.dumps({"fps_1080p_inter": len(want) / dt, "seconds": dt,
                    "frames": len(want),
                    "key_frame_ms": mean("ms", 1),
                    "inter_frame_ms": mean("ms", 0),
                    "inter_plan_ms": mean("inter_plan_ms", 0),
                    "card": card_line()}))

    # the MC pass of the stream's last inter frame, as the decoder gives it
    seen = []
    real = device_recon.mc_into

    def keep(*args):
        seen.append(args)
        return real(*args)
    device_recon.mc_into = keep
    try:
        (_, stats), pf_ms = postfilter_clocked(decode)
    finally:
        device_recon.mc_into = real
    log(json.dumps({"postfilter_1080p_inter": {
        "stream": BIG_INTER, "postfilter_ms_per_frame": pf_ms,
        "card": card_line()}}))
    frame, ref_flat, lanes, cfg = seen[-1]
    frame = frame.clone()
    what = f"{BIG_INTER} frame {len(stats) - 1}"
    lanes_disjoint(lanes, what)
    check_mc(frame, ref_flat, lanes, cfg, what)
    out = time_mc(frame, ref_flat, lanes, cfg, int_rate)
    log(json.dumps({"mc_pass": {
        "frame": len(stats) - 1, **out,
        "inter_plan_ms": stats[-1]["inter_plan_ms"]}}))
    log(f"kernel mc: byte-equal to _mc_plain on the real lanes of {what}, "
        f"{MC_REPEATS} runs; the lanes write disjoint pixels")
    out["ms"] = out["kernel_ms"]
    out["max_abs_err"] = 0
    return launches, out


def phase_checkpoint(datas, want, saved, dev):
    """7a: a fresh Decoder resumes phase 5's checked pass from the blob
    saved before TU CHECKPOINT_TU."""
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    t0 = time.perf_counter()
    blob = saved["blob"]
    dec = Decoder(DecoderConfig(apply_grain=False), device=dev)
    t = time.perf_counter()
    dec.load_state(blob)
    load_ms = (time.perf_counter() - t) * 1e3
    got = []
    for tu in datas[CHECKPOINT_TU:]:
        got += [f.display_md5() for f in dec.decode(tu)]
    dec.close()
    paths = [s["recon_path"] for s in dec.stats]
    if got != want[CHECKPOINT_TU:] or set(paths) != {"device"}:
        same = [g == w for g, w in zip(got, want[CHECKPOINT_TU:])]
        raise AssertionError(f"resumed {BIG_INTER} TUs {CHECKPOINT_TU}-"
                             f"{len(datas) - 1}: frames equal to the "
                             f"manifest {same}, recon paths {paths}")
    log(json.dumps({"checkpoint": {
        "stream": BIG_INTER, "saved_before_tu": CHECKPOINT_TU,
        "resumed_frames": len(got), "all_device_path": True,
        "blob_bytes": len(blob), "save_ms": saved["save_ms"],
        "load_ms": load_ms, "resume_s": time.perf_counter() - t0,
        "card": card_line()}}))


def phase_b7(dev):
    """2 (B7): the residual kernel (`itx.residuals_packed` on the card, one
    launch a call) on every valid (tx_size, tx_type) at 8, 10 and 12
    bits, all packed into one call a bit depth and kind of levels,
    ITX_REPEATS runs, byte-equal to the plain route on the card
    (`_residuals_plain`, `residual_bucket` a bucket) and to its CPU run;
    on conformant levels also to the NumPy spec model; on extreme levels,
    where the plain route wraps in int32, and on spans of SPAN_BLOCKS
    blocks (several CTAs each), to the CPU run."""
    from av1dec_tpu_torch.ops.kernels import itx
    from av1dec_tpu_torch.ops.spec import dequant
    from av1dec_tpu_torch.ops.spec import itx as S
    from av1dec_tpu_torch.ops.tables_data import AC_Q, DC_Q
    rng = np.random.default_rng(7)
    cases = itx.valid_transforms()
    n = launches = 0
    for bd in (8, 10, 12):
        bi = dequant._BD_IDX[bd]
        kinds = {"spec": ([], []), "extreme": ([], None)}
        for tsz, tt in cases:
            w, h = S.TX_DIMS[tsz]
            m = min(w, 32) * min(h, 32)
            B = 5
            qidx = rng.integers(0, 256, B)
            dcd = rng.integers(-8, 9, B)
            acd = rng.integers(-8, 9, B)
            dcq = DC_Q[bi, np.clip(qidx + dcd, 0, 255)].astype(np.int32)
            acq = AC_Q[bi, np.clip(qidx + acd, 0, 255)].astype(np.int32)
            # a conformant range: sparse levels whose dequantized values
            # stay within 2^(e+6) at DC and 2^(e+3) elsewhere, e =
            # min(bd, 11), so that no intermediate leaves int32 (at 12 bits
            # a DC past 2^17 takes an identity-16 row past the 8 + BitDepth
            # bits a conformant stream keeps [SPEC §7.13.3], and its int32
            # product wraps)
            e = min(bd, 11)
            lim = np.maximum(1, (1 << (e + 3)) // acq)[:, None]
            levels = np.floor(rng.uniform(-1, 1, (B, m)) * (lim + 1))
            levels[:, 0] = np.floor(rng.uniform(-1, 1, B) *
                                    np.maximum(1, (1 << (e + 6)) // dcq))
            levels = levels.astype(np.int64)
            levels[rng.random(levels.shape) < 0.6] = 0
            kinds["spec"][0].append((levels.astype(np.int32), dcq, acq,
                                     tsz, tt))
            kinds["spec"][1].append(S.inverse_transform_lanes(
                dequant.dequant_batch(levels, tsz, qidx, bd, dcd, acd),
                tsz, tt, bd))
            # and extreme levels, where int32 wraps on both devices
            wild = rng.integers(-(1 << 20), (1 << 20) + 1, (B, m))
            kinds["extreme"][0].append((wild.astype(np.int32), dcq, acq,
                                        tsz, tt))
        # and spans of SPAN_BLOCKS blocks (the conformant blocks repeated,
        # every other one's levels shuffled), several CTAs each
        spans_of = []
        for lv, dcq, acq, tsz, tt in kinds["spec"][0]:
            if tt in SPAN_TYPES:
                r = -(-SPAN_BLOCKS // len(lv))
                lv = lv.repeat(r, 0)[:SPAN_BLOCKS]
                lv[1::2] = lv[1::2, ::-1]
                spans_of.append((lv, dcq.repeat(r)[:SPAN_BLOCKS],
                                 acq.repeat(r)[:SPAN_BLOCKS], tsz, tt))
        kinds["spans"] = (spans_of, None)
        for kind, (buckets, spec) in kinds.items():
            buf, spans, words = itx.pack_buckets(buckets)
            cpu = itx.residuals_packed(torch.as_tensor(buf), spans, words,
                                       bd)
            dbuf = torch.as_tensor(buf, device=dev)
            plain = itx._residuals_plain(dbuf, spans, words, bd).cpu()
            bad = not torch.equal(plain, cpu)
            for run in range(ITX_REPEATS):
                before = itx.launches
                got = itx.residuals_packed(dbuf, spans, words, bd).cpu()
                launches += itx.launches - before
                bad = bad or itx.launches != before + 1 or \
                    not torch.equal(got, cpu)
            if spec is not None:
                flat = got.numpy()
                for (tsz, tt, _, Bk, _, o0), want in zip(spans, spec):
                    w, h = S.TX_DIMS[tsz]
                    bad = bad or not np.array_equal(
                        flat[o0:o0 + Bk * w * h].reshape(Bk, h, w), want)
            if bad:
                raise AssertionError(f"B7 at {bd} bits, {kind} levels: the "
                                     f"kernel, the plain route on the card, "
                                     f"its CPU run or the NumPy spec differ")
        n += len(cases)
    log(f"kernel itx: byte-equal to the plain route on the card, to its CPU "
        f"run and to the NumPy spec on {n} (tx_size, tx_type, bit depth) "
        f"cases (every valid transform at 8, 10 and 12 bits, one call a bit "
        f"depth), and to the plain route and its CPU run on extreme levels "
        f"and on spans of {SPAN_BLOCKS} blocks (several CTAs each); "
        f"{ITX_REPEATS} runs each, {launches} launches, one a call; max abs "
        f"err 0")


class _Ops:
    """An int32 operand that counts the operations done on it."""
    n = 0

    def _op(self, *_):
        _Ops.n += 1
        return self
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op
    __rshift__ = __neg__ = _op


def transform_ops(kind, n):
    """int32 operations of one n-point 1-D transform of the spec model
    (kind 0 DCT, 1 ADST, 2 identity): its adds, multiplies and shifts."""
    from av1dec_tpu_torch.ops.spec import itx as S
    _Ops.n = 0
    S._apply_1d(kind, [_Ops() for _ in range(n)], n)
    return _Ops.n


def residual_work(buf, spans):
    """(bytes, int32 operations, blocks) of one packed B7 call: the packed
    buffer (descriptors and levels) read once, the int32 residuals
    written once; per coded level the dequantizer (abs, multiply, mask,
    shift, sign, clamp: 7), per pixel the rectangular scale where it
    applies (3), the row and column clamps (4) and the row and final
    roundings (2 each), and each row's and column's 1-D transform."""
    from av1dec_tpu_torch.ops.spec import itx as S
    nbytes = buf.nbytes
    ops = blocks = 0
    for tsz, tt, _, B, _, _ in spans:
        w, h = S.TX_DIMS[tsz]
        ck, rk, _, _ = S.TX_1D[tt]
        rect = (w.bit_length() - h.bit_length()) % 2
        per = (7 * min(w, 32) * min(h, 32) + w * h * (3 * rect + 8) +
               h * transform_ops(rk, w) + w * transform_ops(ck, h))
        ops += B * per
        nbytes += 4 * B * w * h
        blocks += B
    return int(nbytes), int(ops), blocks


# int32 operations of the deblocking filter, the least its decisions and
# filters need, counted from `csrc/deblock.cu` (a clamp is 2, |a - b| 2,
# a multiply by 2 or 3 one).  Per edge line by its length: the
# thresholds (8 a cell, shared by its 4 lines: 2) and the mask m (four
# differences, the x2, /2 and sum, 3 compares, 2 ands: 16) for every
# length; m6 (8), flat6 (2 compares reusing m's differences, 2 more
# differences, 3 ands: 11) and the choice of filter (2) from length 6;
# m8 (8) and flat8 (8) for lengths 8 and 14; flat2 (24) for 14 alone
DEBLOCK_DECISION_OPS = {4: 2 + 16, 6: 2 + 16 + 8 + 11 + 2,
                        8: 2 + 16 + 8 + 11 + 2 + 8 + 8,
                        14: 2 + 16 + 8 + 11 + 2 + 8 + 8 + 24}
# then per edge line by the filter that runs, each as a running sum: the
# 13-tap wide filter (the first output's 16 terms: 15 adds, 11 updates of
# 4, 12 roundings of 2), the 7-tap (first output 6, 5 updates of 4, 6
# roundings), the 5-tap (first 6, 3 updates of 4, 4 roundings) and the
# 4-tap narrow filter with hev (53); a pixel no filter writes is a copy
DEBLOCK_OPS = {"wide": 15 + 11 * 4 + 12 * 2, "8": 6 + 5 * 4 + 6 * 2,
               "6": 6 + 3 * 4 + 4 * 2, "4": 53}
# per Wiener output pixel of a unit that is on: 7 vertical multiply-adds,
# the rounding add and shift and the clamp; per horizontally filtered
# pixel of each (plane, source row, unit row) it needs: the same
SEP_OPS_PER_PX = 7 + 2 + 2
# per superres output pixel: 8 multiply-adds, the rounding add and shift
# and the clip
SUPERRES_OPS_PER_PX = 8 + 2 + 2
# runs of each postfilter kernel on each checked input, each
# byte-compared with its plain version
POST_REPEATS = 5
# phase 2: superres denominators checked (each at 8, 10 and 12 bits)
SUPERRES_DENOMS = (9, 12, 14, 16)
# phase 2: seeded deblock frames (odd sizes, every format, map shapes)
DEBLOCK_SIZE = (61, 83)


def deblock_work(planes, maps, sharp, bd):
    """(bytes, int32 operations, edge lines by length and by filter) of
    `deblock_planes` on these inputs: each plane and cell map read once,
    each output written once; per pass the decision of each edge line
    with a length and the filter each runs, taken from the plain
    version's own masks (`_filter_edges`, on the pass's input)."""
    from av1dec_tpu_torch.ops.kernels import deblock
    seen = []
    real = deblock._filter_edges

    def keep(p, q, length, limit, blimit, thresh, bd_):
        out = real(p, q, length, limit, blimit, thresh, bd_)
        F = 1 << (bd_ - 8)
        flat6 = ((p[1] - p[0]).abs() <= F) & ((q[1] - q[0]).abs() <= F) & \
            ((p[2] - p[0]).abs() <= F) & ((q[2] - q[0]).abs() <= F)
        near, mid, wide = out[2][0], out[2][2], out[2][3]
        w6 = near & ~mid & (length == 6) & flat6
        n = {f"len{L}": int(((length >= 8) & (length != 14)).sum()) if L == 8
             else int((length == L).sum()) for L in DEBLOCK_DECISION_OPS}
        seen.append({**n, "wide": int(wide.sum()),
                     "8": int((mid & ~wide).sum()), "6": int(w6.sum()),
                     "4": int((near & ~mid & ~w6).sum())})
        return out
    deblock._filter_edges = keep
    try:
        deblock._deblock_plain(planes, maps, sharp, bd)
    finally:
        deblock._filter_edges = real
    kinds = {k: sum(s[k] for s in seen) for k in seen[0]}
    ops = sum(kinds[f"len{L}"] * n for L, n in DEBLOCK_DECISION_OPS.items()) \
        + sum(kinds[k] * DEBLOCK_OPS[k] for k in DEBLOCK_OPS)
    nbytes = sum(8 * p.numel() for p in planes) + \
        sum(4 * m.numel() for pm in maps for pair in pm for m in pair)
    return nbytes, ops, kinds


def wiener_work(planes, pre_planes, lr_args):
    """(bytes, int32 operations) of the Wiener pass: each post-CDEF plane
    read once, the pre-CDEF rows a tap reads, the arguments read and the
    output written once; the separable filter's horizontal pass over each
    distinct (plane, source row, unit row) the unit-on pixels need and
    its vertical pass over those pixels."""
    nbytes = ops = 0
    for plane, pre, a in zip(planes, pre_planes, lr_args):
        if a is None:
            continue
        uy, ux, tv, th, act, vr, inside = a
        H, W = plane.shape
        on = act.bool()[uy.long()][:, ux.long()]              # [H, W]
        rows = on.any(1)
        key = ((~inside).long() * H + vr.long()) * act.shape[0] + \
            uy.long()[None, :]                                 # [7, H]
        cols = int(on.any(0).sum())
        nbytes += 8 * plane.numel() + \
            4 * W * torch.unique(vr[~inside]).numel() + \
            sum(t.numel() * t.element_size() for t in a)
        ops += SEP_OPS_PER_PX * (int(on.sum()) + cols * torch.unique(
            key[:, rows]).numel())
    return nbytes, ops


def superres_work(planes, sr_args, outs):
    """(bytes, int32 operations) of an upscale: each source plane and
    table read once, each output written once; per output pixel its
    8-tap filter."""
    px = sum(o.numel() for o in outs)
    nbytes = sum(4 * p.numel() for p in planes) + 4 * px + \
        sum(4 * (c.numel() + t.numel()) for c, t in sr_args)
    return nbytes, px * SUPERRES_OPS_PER_PX


def check_post(name, fn, plain, mod, args, what, per_call=1,
               repeats=POST_REPEATS):
    """`fn(*args)` on the card `repeats` times, each run byte-equal to
    `plain(*args)` on the card and `per_call` launches of the kernel
    (counted in `mod.launches`); returns the launches."""
    want = plain(*args)
    launched = 0
    for run in range(repeats):
        before = mod.launches
        got = fn(*args)
        launched += mod.launches - before
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        if err or len(got) != len(want) or \
                launched != (run + 1) * per_call:
            raise AssertionError(
                f"{name} != plain at {what}, run {run + 1} of {repeats}: "
                f"max abs err {err}, {len(got)} planes (plain {len(want)}), "
                f"{launched} launches")
    return launched


def time_post(name, fn, plain, args, work, int_rate, what, iters=20):
    """A postfilter kernel on one input: every device interval and kernel
    of a call, its kernels' interval, its wrapper-inclusive ms, the plain
    version's device ms and kernels and its ms (CUDA events), and the
    bound of `work` (bytes, int32 operations); logged and returned."""
    d_ms, n_k, k_ms = traced(lambda: fn(*args), name + "_kernel", iters)
    pd_ms, pn_k, _ = traced(lambda: plain(*args), name, 3, one_each=False)
    terms = bound_terms(int_rate, *work[:2])
    out = {"what": what, "device_ms": d_ms, "kernels": n_k,
           "kernel_ms": k_ms, "wrapper_ms": cuda_ms(lambda: fn(*args),
                                                    iters),
           "plain_device_ms": pd_ms, "plain_kernels": pn_k,
           "plain_ms": cuda_ms(lambda: plain(*args), 3), **terms,
           "share_of_bound": terms["bound_ms"] / k_ms, "card": card_line()}
    if len(work) > 2:
        out["edges"] = work[2]
    log(json.dumps({name: out}))
    out["ms"] = k_ms
    out["max_abs_err"] = 0
    return out


def phase_postfilter(dev, int_rate):
    """2 (postfilter): the deblock, superres and Wiener kernels, each
    against its plain version on the card, byte-equal, POST_REPEATS runs
    a check: deblock on seeded frames in the 4 formats at 8, 10 and 12
    bits with sharpness 0, 3 and 7, odd sizes, maps with every length
    beside every other (as large as the planes' cells, smaller and
    larger), the planes read in place through a row stride, and on
    1080p 4:2:0; and on maps whose lengths follow the transform sizes,
    as a stream's do (4 formats, 8 and 12 bits, sharpness 0 and 7, and
    1080p 4:2:0); Wiener on seeded units across stripe, unit-row and
    unit-column boundaries at 1080p 4:2:0 (8, 10, 12 bits; the key
    frame of BIG_HOST40 in phase 8b); superres on 1080p 4:2:0 upscales
    at SUPERRES_DENOMS (`_superres_args`' arithmetic) and 8, 10 and 12
    bits, 3 planes or the final and the pre-CDEF planes (6) in one
    launch.  Then each kernel's times at 1080p 4:2:0 (seeded; deblock on
    both kinds of maps; the entries of deblock and superres are phase
    3b's and 3c's, on a stream's frame).""" 
    from torch_port_helpers import (FORMATS, seeded_deblock,
                                    seeded_wiener_args, smooth_plane,
                                    superres_case)
    from av1dec_tpu_torch.ops.kernels import deblock, lr, superres
    rng = np.random.default_rng(2025)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def deblock_case(H, W, fmt, bd, sharp, kind, rng=rng):
        bases, planes, maps = seeded_deblock(rng, H, W, fmt, bd, kind)
        views = [t(b)[:p.shape[0], :p.shape[1]]
                 for b, p in zip(bases, planes)]
        maps = tuple(tuple(tuple(t(m) for m in pair) for pair in pm)
                     for pm in maps)
        return tuple(views), maps, sharp, bd

    dbl = (deblock.deblock_planes, deblock._deblock_plain, deblock)
    n = launches = 0
    kinds = ("fit", "small", "large")
    for i, (fmt, bd, sharp) in enumerate(itertools.product(
            FORMATS, (8, 10, 12), (0, 3, 7))):
        args = deblock_case(*DEBLOCK_SIZE, fmt, bd, sharp, kinds[i % 3])
        launches += check_post("deblock", *dbl, args,
                               f"{fmt} {bd}-bit sharpness {sharp}",
                               DEBLOCK_PER_FRAME)
        n += 1
    for bd in (10, 8):
        stress = deblock_case(1080, 1920, "420", bd, 0, "fit")
        launches += check_post("deblock", *dbl, stress,
                               f"1080p 4:2:0 {bd}-bit", DEBLOCK_PER_FRAME)
        n += 1
    # maps whose lengths follow the transform sizes, as a stream's do
    # (each pixel has at most one writer), from a generator of their own
    rng_tx = np.random.default_rng(2026)
    for fmt, bd, sharp in itertools.product(FORMATS, (8, 12), (0, 7)):
        args = deblock_case(*DEBLOCK_SIZE, fmt, bd, sharp, "tx", rng_tx)
        launches += check_post("deblock", *dbl, args,
                               f"{fmt} {bd}-bit sharpness {sharp}, "
                               f"transform-size maps", DEBLOCK_PER_FRAME)
        n += 1
    for bd in (10, 8):
        args = deblock_case(1080, 1920, "420", bd, 0, "tx", rng_tx)
        launches += check_post("deblock", *dbl, args,
                               f"1080p 4:2:0 {bd}-bit, transform-size maps",
                               DEBLOCK_PER_FRAME)
        n += 1
    log(f"kernel deblock: byte-equal to _deblock_plain on {n} frames "
        f"({DEBLOCK_SIZE[0]}x{DEBLOCK_SIZE[1]} in 4 formats x 8/10/12-bit "
        f"x sharpness 0/3/7, maps of every length beside every other as "
        f"large as the cells, smaller and larger, planes read through a "
        f"row stride; 1080p 4:2:0 8/10-bit; maps that follow the "
        f"transform sizes in 4 formats x 8/12-bit x sharpness 0/7 and at "
        f"1080p 4:2:0 8/10-bit), {POST_REPEATS} runs each; {launches} "
        f"launches, one a call; max abs err 0")
    time_post("deblock", *dbl[:2], stress, deblock_work(*stress), int_rate,
              "1080p 4:2:0 8-bit, stress maps (every length beside every "
              "other)")
    time_post("deblock", *dbl[:2], args, deblock_work(*args), int_rate,
              "1080p 4:2:0 8-bit, transform-size maps")

    n = launches = 0
    for bd in (8, 10, 12):
        cdef_p, pre_p, wargs = [], [], []
        for plane in range(3):
            a, _, _ = seeded_wiener_args(rng, 1920, 1080, [256, 128, 128],
                                         plane)
            h, w = len(a[0]), len(a[1])
            cdef_p.append(t(smooth_plane(rng, h, w, bd, 40 << (bd - 8))))
            pre_p.append(t(smooth_plane(rng, h, w, bd, 40 << (bd - 8))))
            wargs.append(tuple(t(x) for x in a))
        args = (cdef_p, pre_p, wargs, bd)
        launches += check_post("wiener", lr.lr_wiener_planes,
                               lr._wiener_plain, lr, args,
                               f"1080p 4:2:0 {bd}-bit seeded units")
        n += 1
    log(f"kernel wiener: byte-equal to _wiener_plain on {n} seeded 1080p "
        f"4:2:0 frames (8/10/12-bit; units of 256 and 128, 20 % off, "
        f"across stripe, unit-row and unit-column boundaries), all three "
        f"planes in one launch, {POST_REPEATS} runs each; {launches} "
        f"launches; max abs err 0")
    time_post("wiener", lr.lr_wiener_planes, lr._wiener_plain, args,
              wiener_work(*args[:3]), int_rate,
              "1080p 4:2:0 12-bit, seeded units")

    n = launches = 0
    for i, (denom, bd) in enumerate(itertools.product(SUPERRES_DENOMS,
                                                      (8, 10, 12))):
        planes, sargs = superres_case(rng, 1920, 1080, denom, "420", bd)
        planes = [t(p) for p in planes]
        sargs = [tuple(t(x) for x in a) for a in sargs]
        if i % 2 == 0:  # with the pre-CDEF planes, 6 in one launch
            planes += [t(smooth_plane(rng, *p.shape, bd, 9)) for p in planes]
            sargs *= 2
        launches += check_post("superres", superres.superres_planes,
                               superres._superres_plain, superres,
                               (planes, sargs, bd),
                               f"1080p 4:2:0 {bd}-bit denominator {denom}, "
                               f"{len(planes)} planes")
        n += 1
    log(f"kernel superres: byte-equal to _superres_plain on {n} 1080p "
        f"4:2:0 upscales (denominators {SUPERRES_DENOMS} x 8/10/12-bit; "
        f"3 planes, or the final and pre-CDEF planes, 6 in one launch), "
        f"{POST_REPEATS} runs each; {launches} launches; max abs err 0")
    # the yardstick of the port's first superres kernel (its PERF.md row)
    planes, sargs = superres_case(rng, 1920, 1080, 9, "420", 8)
    args = ([t(p) for p in planes], [tuple(t(x) for x in a)
                                     for a in sargs], 8)
    outs = superres._superres_plain(*args)
    time_post("superres", superres.superres_planes, superres._superres_plain,
              args, superres_work(args[0], args[1], outs), int_rate,
              "1080p 4:2:0 8-bit, denominator 9 (1707 -> 1920)")


def phase_host(manifest, dev, int_rate):
    """6; returns the `cdef_frame` launches of the checked pass and the
    residual kernel's entry: its times on the last host frame."""
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.ops.spec import dequant, itx
    from av1dec_tpu_torch.pipeline import recon
    datas = [d for _, d in read_ivf(os.path.join(TESTDATA,
                                                 BIG_HOST + ".ivf"))]
    want = manifest[BIG_HOST]["frames"]
    want_paths = manifest[BIG_HOST]["paths"]
    n_cdef = cdef_frames(datas)
    seen = []
    real = recon.residuals_device

    def keep(*args):
        seen.append(args)
        return real(*args)

    def decode():
        dec = Decoder(device=dev)
        md5s = []
        for tu in datas:
            md5s += [f.display_md5() for f in dec.decode(tu)]
        dec.close()
        return md5s, dec.stats

    cdef.launches = cdef.frame_launches = 0
    recon.residuals_device = keep
    t0 = time.perf_counter()
    try:
        with Launches("host path") as scans:
            got, stats = decode()
    finally:
        recon.residuals_device = real
    t_first = time.perf_counter() - t0
    launches = cdef.frame_launches
    check_launches(cdef, n_cdef, "host path")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{BIG_HOST} frames differ from the manifest: "
                             f"{bad} of {len(want)}")
    paths = [s["recon_path"] for s in stats]
    n_host = paths.count("host")
    if paths != want_paths or n_host < 1:
        raise AssertionError(f"{BIG_HOST}: recon paths {paths}, the "
                             f"manifest's {want_paths}")
    reasons = sorted({s["host_reason"] for s in stats if s["host_reason"]})
    log(f"host path: {len(got)}/{len(want)} frames of {BIG_HOST} match the "
        f"manifest; {n_host}/{len(paths)} frames on the host pixel path "
        f"({'; '.join(reasons)}); cdef_frame launches {launches} = "
        f"{n_cdef} frames with CDEF on, cdef_filter launches 0; {scans}; "
        f"first pass {t_first:.3f} s")

    # the warm pass, with host clocks around FrameRecon's stages
    spent = dict.fromkeys(("residuals", "postfilter", "cdef"), 0.0)
    FR = recon.FrameRecon
    stages = {"residuals": "_precompute_residuals",
              "postfilter": "_postfilter", "cdef": "_cdef"}
    real_stage = {k: getattr(FR, m) for k, m in stages.items()}

    def clocked(key):
        def call(self):
            t = time.perf_counter()
            try:
                return real_stage[key](self)
            finally:
                spent[key] += time.perf_counter() - t
        return call
    for k, m in stages.items():
        setattr(FR, m, clocked(k))
    t0 = time.perf_counter()
    try:
        _, stats = decode()
    finally:
        for k, m in stages.items():
            setattr(FR, m, real_stage[k])
    dt = time.perf_counter() - t0

    def mean(path):
        v = [s["ms"] for s in stats if s["recon_path"] == path]
        return sum(v) / len(v)
    host_ms = mean("host")
    per = {k: v * 1e3 / n_host for k, v in spent.items()}
    log(json.dumps({"fps_1080p_host": len(want) / dt, "seconds": dt,
                    "frames": len(want), "host_frames": n_host,
                    "host_frame_ms": host_ms,
                    "device_frame_ms": mean("device"),
                    "host_stage_ms_per_frame": {
                        "residuals (B7, fetch)": per["residuals"],
                        "block walk": host_ms - per["residuals"] -
                        per["postfilter"],
                        "deblock, superres, LR (NumPy)":
                        per["postfilter"] - per["cdef"],
                        "cdef (upload, cdef_frame, fetch)": per["cdef"]},
                    "card": card_line()}))

    # B7 on the last host frame's buckets, as FrameRecon gives them
    from av1dec_tpu_torch.ops.kernels import itx as K
    buckets, bd, _ = seen[-1]

    def run():
        return recon.residuals_device(buckets, bd, dev)
    d_ms, n_k, k_ms = traced(run, "itx_kernel", 20)
    out = run()
    t0 = time.perf_counter()
    for _ in range(5):
        run()  # ends in the fetch: synchronous
    w_ms = (time.perf_counter() - t0) * 1e3 / 5

    def numpy_route():
        return [itx.inverse_transform_lanes(
            dequant.dequant_batch(lv, tsz, q, bd, dc, ac), tsz, tt, bd)
            for lv, q, dc, ac, tsz, tt in buckets]
    ref = numpy_route()
    if not all(np.array_equal(a, b) for a, b in zip(out, ref)):
        raise AssertionError("B7 on the card != the NumPy route on the "
                             "host frame's buckets")
    t0 = time.perf_counter()
    for _ in range(3):
        numpy_route()
    np_ms = (time.perf_counter() - t0) * 1e3 / 3
    buf, spans, words = recon.pack_residuals(buckets, bd)
    dbuf = torch.as_tensor(buf, device=dev)
    p_ms = cuda_ms(lambda: K._residuals_plain(dbuf, spans, words, bd), 3)
    nbytes, ops, blocks = residual_work(buf, spans)
    terms = bound_terms(int_rate, nbytes, ops)
    entry = {"frame": len(stats) - 1 - paths[::-1].index("host"),
             "buckets": len(buckets), "blocks": blocks, "device_ms": d_ms,
             "kernels": n_k, "kernel_ms": k_ms, "wrapper_ms": w_ms,
             "numpy_ms": np_ms, "plain_ms": p_ms, **terms,
             "share_of_bound": terms["bound_ms"] / k_ms,
             "card": card_line()}
    log(json.dumps({"residuals": entry}))
    entry["ms"] = k_ms
    entry["max_abs_err"] = 0
    return launches, entry


def phase_scale_out(manifest, dev, int_rate, frame0):
    """7b-e; returns the `cdef_filter` launches of the checked calls."""
    import tempfile

    from av1dec_tpu_torch.container import decode_gops_parallel, read_ivf
    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.parallel.worker import (launch, plane_md5s,
                                                  save_cdef_input)
    big = os.path.join(TESTDATA, BIG + ".ivf")
    want = manifest[BIG]["frames"]
    with tempfile.TemporaryDirectory() as tmp:
        # b: GOP-parallel on the first GOP_TUS key frames
        path = os.path.join(tmp, "gops.ivf")
        with open(big, "rb") as f:
            head = f.read(32)
        with open(path, "wb") as f:
            f.write(head)
            for i, (pts, tu) in enumerate(read_ivf(big)):
                if i == GOP_TUS:
                    break
                f.write(len(tu).to_bytes(4, "little") +
                        pts.to_bytes(8, "little") + tu)
        stats = []
        t0 = time.perf_counter()
        frames = decode_gops_parallel(path, workers=2, device=dev,
                                      stats=stats)
        dt = time.perf_counter() - t0
        got = [f.display_md5() for f in frames]
        if got != want[:GOP_TUS] or len(stats) != GOP_TUS:
            raise AssertionError(f"GOP-parallel {BIG}: {len(got)} frames, "
                                 f"{len(stats)} GOPs, equal to the "
                                 f"manifest: {got == want[:GOP_TUS]}")
        # each worker frame's scan ran on the kernel, one launch to its
        # last level
        levels = frame_levels(BIG, GOP_TUS)
        scanned = [[(r["scan_launches"], r["scan_levels"])
                    for r in st["frames"]] for st in stats]
        if scanned != [[(1, levels[st["gop"]])] for st in stats]:
            raise AssertionError(f"GOP workers' (wavefront_scan launches, "
                                 f"levels complete) {scanned}, levels "
                                 f"with lanes {levels}")
        # and its deblock on the kernel, one launch a pass
        dbl = deblock_frames(BIG, max(GOP_TUS, 2))
        deblocked = [[r["deblock_launches"] for r in st["frames"]]
                     for st in stats]
        if deblocked != [[DEBLOCK_PER_FRAME * dbl[st["gop"]]]
                         for st in stats]:
            raise AssertionError(f"GOP workers' deblock launches "
                                 f"{deblocked}, frames with a loop-filter "
                                 f"level {dbl}")
        per_worker = {}
        for st in stats:
            per_worker.setdefault(st["pid"], []).extend(
                r["ms"] for r in st["frames"])
        log(json.dumps({"gop_parallel": {
            "stream": f"{BIG} TUs 0-{GOP_TUS - 1}", "gops": len(stats),
            "workers": 2, "fps": len(got) / dt, "seconds": dt,
            "scan_launches": scanned, "deblock_launches": deblocked,
            "worker_frame_ms": list(per_worker.values()),
            "card": card_line()}}))

        # c, d: one launch of SCALE_RANKS gloo ranks on the card
        planes, *gates, bd, damping, sx, sy = frame0
        npz = os.path.join(tmp, "frame0.npz")
        save_cdef_input(npz, planes, tuple(gates) + (damping, sx, sy), bd)
        whole = plane_md5s(cdef._cdef_core(planes, *gates, bd, damping, sx,
                                           sy))
        if plane_md5s(cdef.cdef_frame(planes, *gates, bd, damping, sx,
                                      sy)) != whole:
            raise AssertionError("cdef_frame != _cdef_core on frame 0")
        t0 = time.perf_counter()
        res = launch(SCALE_RANKS, os.path.join(tmp, "ranks"),
                     ["--cdef", npz, "--n-space", *N_SPACE, "--time",
                      TIME_ITERS, "--frames", big],
                     backend="gloo", device="cuda", timeout=400)
        t_launch = time.perf_counter() - t0
        launches = 0
        rows = []
        for rec in res:
            if rec["all_reduce"] != SCALE_RANKS * (SCALE_RANKS - 1) // 2:
                raise AssertionError(f"rank {rec['rank']}: all_reduce "
                                     f"{rec['all_reduce']}")
            if rec["frames"] != want[:2] or rec["scan_launches"] != 1 or \
                    rec["scan_levels"] != levels[rec["frame_index"]] or \
                    rec["deblock_launches"] != \
                    DEBLOCK_PER_FRAME * dbl[rec["frame_index"]]:
                raise AssertionError(
                    f"rank {rec['rank']}: sharded frames equal to the "
                    f"manifest {rec['frames'] == want[:2]}; frame "
                    f"{rec['frame_index']}'s wavefront_scan launches "
                    f"{rec['scan_launches']} (1 expected), levels complete "
                    f"{rec['scan_levels']}, levels with lanes "
                    f"{levels[rec['frame_index']]}, deblock launches "
                    f"{rec['deblock_launches']} (loop-filter level "
                    f"{dbl[rec['frame_index']]})")
            for n in N_SPACE:
                c = rec["cdef"][str(n)]
                if c["md5"] != whole or c["launches"] != 1 or \
                        c["max_abs_err"]:
                    raise AssertionError(
                        f"rank {rec['rank']} n_space {n}: sharded CDEF "
                        f"equal to _cdef_core: {c['md5'] == whole}, "
                        f"cdef_filter launches {c['launches']} (1 "
                        f"expected), max abs err against "
                        f"_cdef_shard_core {c['max_abs_err']}")
                launches += c["launches"]
                terms = bound_terms(int_rate, *shard_work(
                    planes, gates, bd, sx, sy, n, c["space_index"]))
                rows.append({"rank": rec["rank"], "n_space": n,
                             "shard_widths": c["shard_widths"],
                             "kernel_ms": c["kernel_ms"],
                             "kernels_per_call": c["kernels_per_call"],
                             "kernel_timed_by": c["kernel_timed_by"],
                             "wrapper_ms": c["wrapper_ms"],
                             "plain_ms": c["plain_ms"],
                             "halo_ms": c["halo_ms"], **terms,
                             "share_of_bound":
                             terms["bound_ms"] / c["kernel_ms"]})
        log(f"sharded CDEF: {SCALE_RANKS} gloo ranks on the card, n_space "
            f"{' and '.join(map(str, N_SPACE))}: every rank byte-equal to "
            f"_cdef_core on the whole frame, 1 cdef_filter launch per "
            f"rank per call ({launches}), each byte-equal to "
            f"_cdef_shard_core on its bordered planes; sharded frames 0-1 "
            f"at data=2 match the manifest on every rank, each rank's scan "
            f"one wavefront_scan launch to its last level, its deblock "
            f"launches {DEBLOCK_PER_FRAME} a frame with a loop-filter level "
            f"({[r['deblock_launches'] for r in res]}; frames "
            f"{res[0]['frames_s']:.3f} s on rank 0); launch "
            f"{t_launch:.3f} s")
        log(json.dumps({"sharded_cdef": rows, "card": card_line()}))

        # e: the NCCL path, one rank with a card of its own
        t0 = time.perf_counter()
        res = launch(1, os.path.join(tmp, "nccl"),
                     ["--cdef", npz, "--n-space", 1], device="cuda",
                     timeout=200)[0]
        c = res["cdef"]["1"]
        if res["backend"] != "nccl" or res["all_reduce"] != 0 or \
                c["md5"] != whole or c["launches"] != 1 or \
                c["max_abs_err"]:
            raise AssertionError(f"NCCL rank: backend {res['backend']}, "
                                 f"equal to _cdef_core {c['md5'] == whole}"
                                 f", cdef_filter launches {c['launches']}"
                                 f", max abs err {c['max_abs_err']}")
        launches += c["launches"]
        log(f"NCCL: world-size-1 group (backend picked: {res['backend']}), "
            f"sharded CDEF at n_space 1 byte-equal to _cdef_core, 1 "
            f"cdef_filter launch byte-equal to _cdef_shard_core; launch "
            f"{time.perf_counter() - t0:.3f} s")
    return launches


def read_tus(name):
    from av1dec_tpu_torch.container import read_ivf
    return [d for _, d in read_ivf(os.path.join(TESTDATA, name + ".ivf"))]


def phase_compound(manifest, dev, int_rate):
    """8a: compound frames at 1080p through `Decoder(device="cuda")`;
    returns the `cdef_frame` launches of the checked pass."""
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.pipeline import device_recon
    datas = read_tus(BIG_COMPOUND)
    want = manifest[BIG_COMPOUND]["frames"]
    want_paths = manifest[BIG_COMPOUND]["paths"]
    n_cdef = cdef_frames(datas)
    seen = []
    real = device_recon.mc_into

    def keep(*args):
        seen.append(args)
        return real(*args)

    def decode():
        dec = Decoder(device=dev)
        md5s = []
        for tu in datas:
            md5s += [f.display_md5() for f in dec.decode(tu)]
        dec.close()
        return md5s, dec.stats

    cdef.launches = cdef.frame_launches = 0
    device_recon.mc_into = keep
    t0 = time.perf_counter()
    try:
        with Launches("compound") as scans:
            got, stats = decode()
    finally:
        device_recon.mc_into = real
    t_first = time.perf_counter() - t0
    launches = cdef.frame_launches
    check_launches(cdef, n_cdef, "compound")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{BIG_COMPOUND} frames differ from the "
                             f"manifest: {bad} of {len(want)}")
    paths = [s["recon_path"] for s in stats]
    if paths != want_paths:
        raise AssertionError(f"{BIG_COMPOUND}: recon paths {paths}, the "
                             f"manifest's {want_paths}")
    comp = [sum(n for _, c, n in cfg[0] if c) for *_, cfg in seen]
    if sum(comp) < 1:
        raise AssertionError(f"{BIG_COMPOUND}: no compound MC lane")
    log(f"compound: {len(got)}/{len(want)} frames of {BIG_COMPOUND} match "
        f"the manifest, all on the device path; {sum(comp)} compound MC "
        f"lanes in {sum(c > 0 for c in comp)} of {len(seen)} MC passes; "
        f"cdef_frame launches {launches} = {n_cdef} frames with CDEF on, "
        f"cdef_filter launches 0; {scans}; first pass {t_first:.3f} s")

    t0 = time.perf_counter()
    _, stats = decode()
    dt = time.perf_counter() - t0

    def mean(key, intra):
        v = [s[key] for s in stats if s["intra"] == intra]
        return sum(v) / len(v)
    log(json.dumps({"fps_1080p_compound": len(want) / dt, "seconds": dt,
                    "frames": len(want),
                    "key_frame_ms": mean("ms", 1),
                    "inter_frame_ms": mean("ms", 0),
                    "inter_plan_ms": mean("inter_plan_ms", 0),
                    "compound_lanes": sum(comp),
                    "card": card_line()}))
    _, pf_ms = postfilter_clocked(decode)
    log(json.dumps({"postfilter_1080p_compound": {
        "stream": BIG_COMPOUND, "postfilter_ms_per_frame": pf_ms,
        "card": card_line()}}))

    # the MC pass of the last frame with compound lanes
    last = max(i for i, c in enumerate(comp) if c)
    frame, ref_flat, lanes, cfg = seen[last]
    frame = frame.clone()
    what = f"{BIG_COMPOUND} MC pass {last}"
    lanes_disjoint(lanes, what)
    check_mc(frame, ref_flat, lanes, cfg, what)
    log(json.dumps({"mc_pass_compound": {
        "mc_pass": last, "compound_lanes": comp[last],
        **time_mc(frame, ref_flat, lanes, cfg, int_rate)}}))
    log(f"kernel mc: byte-equal to _mc_plain on the real lanes of {what} "
        f"(the last with compound lanes), {MC_REPEATS} runs; the lanes "
        f"write disjoint pixels")
    return launches


def phase_wiener(manifest, dev, int_rate):
    """8b: the key frame of the cq-40 host stream, whose Wiener units'
    stripe-boundary rows the reference's device pass got wrong, on the
    device path (device Wiener) against the manifest; then the Wiener
    kernel on that frame's own inputs, byte-equal to `_wiener_plain`
    POST_REPEATS runs, and its times.  Returns the `cdef_frame` launches
    and the Wiener kernel's entry."""
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.ops.kernels import cdef, lr
    from av1dec_tpu_torch.pipeline import device_recon
    datas = read_tus(BIG_HOST40)[:1]
    kept = []
    calls = []
    real = api.DeviceRecon
    real_lr = device_recon.lr_wiener_planes

    class Keep(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    def keep_lr(*args):
        calls.append(args)
        return real_lr(*args)
    cdef.launches = cdef.frame_launches = 0
    api.DeviceRecon = Keep
    device_recon.lr_wiener_planes = keep_lr
    t0 = time.perf_counter()
    try:
        with Launches("cq-40 key frame") as scans:
            dec = api.Decoder(device=dev)
            got = [f.display_md5() for f in dec.decode(datas[0])]
            dec.close()
    finally:
        api.DeviceRecon = real
        device_recon.lr_wiener_planes = real_lr
    dt = time.perf_counter() - t0
    check_launches(cdef, cdef_frames(datas), "cq-40 key frame")
    st = dec.stats[0]
    if got != manifest[BIG_HOST40]["frames"][:1] or \
            st["recon_path"] != "device" or not st["lr"] or \
            not kept[0]._lr_on_device or scans.wieners != 1:
        raise AssertionError(f"{BIG_HOST40} TU 0: equal to the manifest "
                             f"{got == manifest[BIG_HOST40]['frames'][:1]}"
                             f", path {st['recon_path']}, LR {st['lr']}, "
                             f"Wiener on the device {kept[0]._lr_on_device}"
                             f", wiener launches {scans.wieners}")
    log(f"Wiener: {BIG_HOST40} key frame on the device path, LR (Wiener) "
        f"on the device in one wiener launch, matches the manifest; "
        f"cdef_frame launches {cdef.frame_launches}; {scans}; {dt:.3f} s")
    args = calls[-1]
    what = f"{BIG_HOST40} key frame (its planes and units)"
    check_post("wiener", lr.lr_wiener_planes, lr._wiener_plain, lr, args,
               what)
    return cdef.frame_launches, time_post(
        "wiener", lr.lr_wiener_planes, lr._wiener_plain, args,
        wiener_work(*args[:3]), int_rate, what)


def phase_batched_host(manifest, dev):
    """8c: `decode_stream_batched` on `screen`'s TU 0, an intra block
    copy key frame, decoded inline on the host pixel path; returns the
    `cdef_frame` launches."""
    from av1dec_tpu_torch.api import decode_stream_batched, display_md5
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.ops.kernels import cdef
    datas = read_tus(SCREEN)[:1]
    parser = NativeParser()
    hdr, = parser.parse_tu(datas[0])
    seq = parser.seq
    parser.close()
    cdef.launches = cdef.frame_launches = 0
    tm = {}
    with Launches("batched host frame") as scans:
        out = decode_stream_batched(datas, device=dev, batch=4, timings=tm)
    check_launches(cdef, cdef_frames(datas), "batched host frame")
    got = display_md5(out[0], seq["bit_depth"], hdr["upscaled_width"],
                      hdr["frame_height"],
                      (seq["subsampling_x"], seq["subsampling_y"]))
    if len(out) != 1 or got != manifest[SCREEN]["frames"][0] or \
            manifest[SCREEN]["paths"][0] != "host" or not tm["host_path"]:
        raise AssertionError(f"batched {SCREEN} TU 0: equal to the "
                             f"manifest {got == manifest[SCREEN]['frames'][0]}"
                             f", host path {tm['host_path']:.3f} s")
    log(f"batched entry point: {SCREEN} TU 0 (intra block copy) inline on "
        f"the host pixel path, matches the manifest; host path "
        f"{tm['host_path'] * 1e3:.3f} ms; cdef_frame launches "
        f"{cdef.frame_launches}; {scans}")
    return cdef.frame_launches


def phase_space_shards(manifest, dev, int_rate, frame0):
    """8d-e: `cdef_local` on phase 3's frame 0 in 2 and 4 column shards
    on the card repeated, and `Decoder(DecoderConfig(space_shards=2))`
    on the intra stream's TU 0, once with the card repeated as its shard
    devices and once with the default devices (one card: the fallback);
    every `cdef_shard` launch held against `_cdef_shard_core` on the same
    bordered planes and strengths.  Returns (`cdef_frame` launches,
    `cdef_filter` launches, the kernel's entry: its times on shard 0 of
    2)."""
    import logging

    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.parallel import sharded_cdef
    from av1dec_tpu_torch.parallel.worker import plane_md5s
    planes, *gates, bd, damping, sx, sy = frame0
    whole = plane_md5s(cdef._cdef_core(planes, *gates, bd, damping, sx,
                                       sy))
    want = manifest[BIG]["frames"][:1]
    datas = read_tus(BIG)[:1]
    errs = []
    real = cdef.cdef_shard
    real_devices = sharded_cdef.local_devices

    def checked(*args):
        out = real(*args)
        ref = cdef._cdef_shard_core(*args)
        errs.append(max(int((o - r).abs().max()) for o, r in zip(out, ref)))
        return out

    def decode():
        dec = Decoder(DecoderConfig(space_shards=2), device=dev)
        got = [f.display_md5() for f in dec.decode(datas[0])]
        dec.close()
        return got

    filter_launches = 0
    cdef.cdef_shard = checked
    try:
        for n in SHARDS:
            cdef.launches = cdef.frame_launches = 0
            out = sharded_cdef.cdef_local(planes, tuple(gates) +
                                          (damping, sx, sy), bd, [dev] * n)
            if plane_md5s(out) != whole or cdef.launches != n or \
                    cdef.frame_launches or max(errs):
                raise AssertionError(
                    f"cdef_local at {n} shards: equal to _cdef_core "
                    f"{plane_md5s(out) == whole}, cdef_filter launches "
                    f"{cdef.launches} ({n} expected), max abs err "
                    f"against _cdef_shard_core {max(errs)}")
            filter_launches += cdef.launches
        cdef.launches = cdef.frame_launches = 0
        before = sharded_cdef.local_frames
        sharded_cdef.local_devices = lambda d: [dev, dev]
        try:
            with Launches("space_shards=2, the card twice"):
                got = decode()
        finally:
            sharded_cdef.local_devices = real_devices
        if got != want or cdef.launches != 2 or cdef.frame_launches or \
                sharded_cdef.local_frames != before + 1 or max(errs):
            raise AssertionError(
                f"Decoder space_shards=2 on the card repeated: equal to "
                f"the manifest {got == want}, cdef_filter launches "
                f"{cdef.launches} (2 expected), cdef_frame launches "
                f"{cdef.frame_launches}, max abs err {max(errs)}")
        filter_launches += cdef.launches
    finally:
        cdef.cdef_shard = real
    n_checked = len(errs)

    warned = []

    class Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())
    logger = logging.getLogger("av1dec_tpu_torch")
    handler = Catch(logging.WARNING)
    logger.addHandler(handler)
    cdef.launches = cdef.frame_launches = 0
    try:
        with Launches("space_shards=2, one card"):
            got = decode()
    finally:
        logger.removeHandler(handler)
    frame_launches = cdef.frame_launches
    if got != want or cdef.launches or frame_launches != 1 or \
            not any("device(s) for 2 shards" in w for w in warned):
        raise AssertionError(f"Decoder space_shards=2 on one card: equal "
                             f"to the manifest {got == want}, cdef_frame "
                             f"launches {frame_launches}, cdef_filter "
                             f"launches {cdef.launches}, warnings {warned}")
    log(f"space_shards: cdef_local at {' and '.join(map(str, SHARDS))} "
        f"shards on the card repeated equals _cdef_core on {BIG} frame 0; "
        f"Decoder(space_shards=2) with the card twice as the process's "
        f"devices matches the manifest on TU 0; {filter_launches} "
        f"cdef_filter launches, one a shard, each ({n_checked}) "
        f"byte-equal to _cdef_shard_core on its bordered planes; with the "
        f"default devices (one card) it logs '{warned[0]}', runs "
        f"cdef_frame and matches the manifest")

    # shard 0 of 2: the inputs of cdef_local's first launch at 2 shards
    pads, strengths = shard_inputs(planes, gates, SHARDS[0], 0)
    args = (pads, *strengths, bd, damping, sx, sy)
    k = kernel_ms(lambda: cdef.cdef_shard(*args), "cdef_shard_kernel", 50)
    w = cuda_ms(lambda: cdef.cdef_shard(*args), 50)
    p = cuda_ms(lambda: cdef._cdef_shard_core(*args), 5)
    terms = bound_terms(int_rate, *shard_work(planes, gates, bd, sx, sy,
                                              SHARDS[0], 0))
    log(json.dumps({"space_shards_cdef": {
        "shards": SHARDS[0], "shard": 0,
        "pads": [tuple(t.shape) for t in pads], "kernel_ms": k,
        "wrapper_ms": w, "plain_ms": p, **terms,
        "share_of_bound": terms["bound_ms"] / k, "card": card_line()}}))
    return frame_launches, filter_launches, {
        "max_abs_err": max(errs), "ms": k, "plain_ms": p,
        "bound_ms": terms["bound_ms"], "bound_by": terms["bound_by"]}


def timed_phase(name, fn, *args):
    """fn(*args), with its wall seconds logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the repo, and `tests/` for the seeded MC lanes and the lanes' pixels
    sys.path[:0] = [_REPO, os.path.join(_REPO, "tests")]
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

    frame = timed_phase("2 (kernels)", phase_kernels, dev, int_rate)
    scan = timed_phase("2 (scan)", phase_scan, manifest, dev, int_rate)
    timed_phase("2 (MC)", phase_mc, dev)
    timed_phase("2 (B7)", phase_b7, dev)
    timed_phase("2 (postfilter)", phase_postfilter, dev, int_rate)
    launches, frame0 = timed_phase("3", phase_main_path, manifest, dev,
                                   int_rate)
    n, deblock_entry = timed_phase("3b", phase_lf_stream, manifest, dev,
                                   int_rate)
    launches += n
    n, superres_entry = timed_phase("3c", phase_sres_stream, manifest, dev,
                                    int_rate)
    launches += n
    timed_phase("4", phase_entry_point, manifest, dev)
    n, mc_entry = timed_phase("5 (with 7a)", phase_inter, manifest, dev,
                              int_rate)
    launches += n
    n, itx_entry = timed_phase("6", phase_host, manifest, dev, int_rate)
    launches += n
    # the itx entry's error covers the device path's batches of phase 2
    itx_entry["max_abs_err"] = max(itx_entry["max_abs_err"],
                                   scan["itx_max_abs_err"])
    filter_launches = timed_phase("7b-e", phase_scale_out, manifest, dev,
                                  int_rate, frame0)
    launches += timed_phase("8a", phase_compound, manifest, dev, int_rate)
    n, wiener_entry = timed_phase("8b", phase_wiener, manifest, dev,
                                  int_rate)
    launches += n
    launches += timed_phase("8c", phase_batched_host, manifest, dev)
    n_frame, n_filter, path = timed_phase("8d-e", phase_space_shards,
                                          manifest, dev, int_rate, frame0)
    launches += n_frame
    filter_launches += n_filter
    # the shard kernel's entry: its times on the shard of its Decoder-path
    # launches (phase 8d: shard 0 of 2 in one process, 7c's rank 0's
    # shard at n_space 2); its error phase 8's (phases 2 and 7 raise on
    # any)

    def line(name, replaces, k, n):
        return {"name": name, "route": "cuda",
                "source": f"av1dec_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}
    # the scan kernel's entry: its times on BIG's first batch (phase 2),
    # its launches those of every checked scan of phases 3-8 in this
    # process; the MC kernel's its times on BIG_INTER's frame 7 (phase
    # 5), the residual kernel's on BIG_HOST's last host frame (phase 6),
    # their launches those of every checked decode of phases 3-8; the
    # deblock kernel's its times on BIG_LF's frame 0 (phase 3b), superres's
    # on BIG_SRES's frame 0 (phase 3c), Wiener's on BIG_HOST40's
    # key frame (phase 8b), their launches those of every checked decode
    # of phases 3-8 in this process
    scan["ms"] = scan["device_ms"]
    log(json.dumps({"kernels": [
        line("cdef_frame", "av1dec_tpu/ops/kernels/cdef.py:342", frame,
             launches),
        line("cdef_filter", "av1dec_tpu/ops/kernels/cdef.py:342", path,
             filter_launches),
        line("wavefront_scan", "av1dec_tpu/ops/kernels/wavefront.py:343",
             scan, sum(MAIN_SCANS)),
        line("mc", "av1dec_tpu/ops/kernels/mc.py:84", mc_entry,
             sum(MAIN_MC)),
        line("itx", "av1dec_tpu/ops/kernels/itx.py:88", itx_entry,
             sum(MAIN_ITX)),
        line("deblock", "av1dec_tpu/ops/kernels/deblock.py:219",
             deblock_entry, sum(MAIN_DEBLOCK)),
        line("superres", "av1dec_tpu/pipeline/device_recon.py:84",
             superres_entry, sum(MAIN_SUPERRES)),
        line("wiener", "av1dec_tpu/ops/kernels/lr.py:29", wiener_entry,
             sum(MAIN_WIENER)),
    ]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
