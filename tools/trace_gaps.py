"""The card's idle time charged to the port's own spans, and the port's
copy counters held to the copies of a device trace, on one CUDA card.

    python3 tools/trace_gaps.py [--cells inter.device inter.host]
        [--seed N] [--seconds S] [--runs N] [--out FILE]

For each `Decoder` cell of BENCHMARK.json, set up and warmed as
`portbench/run.py` does it, one window of the cell's calls (`--seconds`,
default the benchmark's `run_seconds`) runs under
`pbcore.trace.profile_calls` inside `tracing.collect()` and the
benchmark's `spans.Instrument` (whose `Decoder.decode` spans bound each
call), traced again after a longer wait until the trace is whole, as
`run.py` does.  Of that trace it reports:

1. `midpoint`: `pbcore.trace.read` given the program's spans: each idle
   gap charged whole to the span open at its midpoint; `bench_midpoint`
   the same with the benchmark's own spans (the ledger's `breakdown`);
2. `piecewise`: each instant of each idle gap charged to the innermost
   program span open on the decoding thread then; an instant with no
   span open to `no span, in Decoder.decode` or `between calls` (the
   harness's frame digest and its loop).  `inside_calls_s` is the idle
   time inside `Decoder.decode` calls, `below_decode_share` the share of
   it in a program span other than `decode`'s own self time;
3. `copies`: the window's `Decoder.stats` `h2d_copies` and `d2h_copies`
   against the trace's `Memcpy HtoD` and `Memcpy DtoH` events between
   its markers (`equal`), and both by the program span that was open
   when each was made (a trace's copy by its host time);
4. `split`: the mean `spans_ms` of the window's key frames, device-path
   inter frames and host-path frames.

Then `collect_cost`: `fps` of `--runs` pairs of `run.run_cell(...,
trace=0)` runs of the cell, one without and one with
`tracing.collect()` around it, in turns, each pair on its own seed.

Writes everything as JSON to `--out` (default
`chiprun_out/trace_gaps.json`) and a summary on standard error.  Needs
a CUDA card; exits with 2 without one.
"""
import argparse
import bisect
import json
import os
import re
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "portbench"))

import run as bench  # noqa: E402  (standard library only at import)
from pbcore import spec  # noqa: E402

H2D = re.compile(r"Memcpy.?HtoD")
D2H = re.compile(r"Memcpy.?DtoH")
NO_SPAN = "no span, in Decoder.decode"
BETWEEN = "between calls"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def window_of(ev, h0):
    """(w0, w1) of the trace's markers (device us), the events between
    them, and its idle gaps on the host clock [(a, b)]."""
    from pbcore import trace as tr
    marks = sorted((e for e in ev if tr.MARKER in e[0]), key=lambda e: e[1])
    w0, w1 = marks[0][2], marks[1][1]
    inside = [e for e in ev if tr.MARKER not in e[0] and e[1] >= w0 and
              e[2] <= w1]
    busy = tr._union([(s, e) for _, s, e in inside])
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = [(h0 + (a - w0) / 1e6, h0 + (b - w0) / 1e6)
            for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return (w0, w1), inside, gaps


def innermost(records, thread):
    """The innermost program span on `thread` at each instant: sorted,
    disjoint segments [(a, b, name or None)] that cover the whole clock
    (spans of one thread nest)."""
    rs = sorted((r for r in records if r[1] == thread),
                key=lambda r: (r[2], -r[3]))
    segs, stack, cur = [], [], float("-inf")

    def emit(a, b):
        if b > a:
            segs.append((a, b, stack[-1][0] if stack else None))
    for r in rs:
        while stack and stack[-1][3] <= r[2]:
            emit(cur, stack[-1][3])
            cur = stack.pop()[3]
        emit(cur, r[2])
        stack.append(r)
        cur = r[2]
    while stack:
        emit(cur, stack[-1][3])
        cur = stack.pop()[3]
    emit(cur, float("inf"))
    return segs


def overlap(a, b, intervals, ends):
    """Seconds of [a, b] inside the sorted disjoint `intervals`, whose
    ends are `ends`."""
    s, k = 0.0, bisect.bisect_right(ends, a)
    while k < len(intervals) and intervals[k][0] < b:
        s += max(0.0, min(b, intervals[k][1]) - max(a, intervals[k][0]))
        k += 1
    return s


def piecewise(gaps, segs, calls):
    """Idle seconds of `gaps` (sorted, disjoint) by the innermost span
    of `segs`; an instant no span covers goes to NO_SPAN inside a
    `Decoder.decode` call (`calls`, sorted), to BETWEEN outside."""
    out = {}
    ends = [b for _, b in calls]

    def add(key, s):
        if s > 0:
            out[key] = out.get(key, 0.0) + s
    i = j = 0
    while i < len(gaps) and j < len(segs):
        (ga, gb), (a, b, name) = gaps[i], segs[j]
        lo, hi = max(ga, a), min(gb, b)
        if hi > lo:
            if name is None:
                inside = overlap(lo, hi, calls, ends)
                add(NO_SPAN, inside)
                add(BETWEEN, hi - lo - inside)
            else:
                add(name, hi - lo)
        if gb < b:
            i += 1
        else:
            j += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_at(segs, starts, t):
    k = bisect.bisect_right(starts, t) - 1
    return (segs[k][2] if k >= 0 else None) or "no span"


def mean_split(stats):
    """Mean `spans_ms` (and copies) of key frames, device-path inter
    frames and host-path frames."""
    out = {}
    for cls, keep in (("key", lambda s: s["intra"]),
                      ("device_inter", lambda s: not s["intra"] and
                       s["recon_path"] == "device"),
                      ("host", lambda s: s["recon_path"] == "host")):
        st = [s for s in stats if keep(s)]
        if not st:
            continue
        names = sorted({k for s in st for k in s["spans_ms"]})
        out[cls] = {"frames": len(st),
                    "ms": sum(s["ms"] for s in st) / len(st),
                    "spans_ms": {k: sum(s["spans_ms"].get(k, 0.0)
                                        for s in st) / len(st)
                                 for k in names}}
        for k in ("h2d_copies", "h2d_bytes", "d2h_copies", "d2h_bytes"):
            out[cls][k] = sum(s[k] for s in st) / len(st)
        out[cls]["inter_blocks"] = sum(sum(s["inter_blocks"].values())
                                       for s in st) / len(st)
    return out


def span_cost(n=200000):
    """Microseconds of one span entered and left in a unit, and of one
    call through a `traced` function over a bare call, on this host."""
    import time
    from av1dec_tpu_torch import tracing
    sp = tracing.span("emit")

    def bare():
        return None
    wrapped = tracing.traced("host.inter_pred")(bare)
    with tracing.unit(tracing.Unit(-1, 0)):
        t0 = time.perf_counter()
        for _ in range(n):
            with sp:
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            wrapped()
        t2 = time.perf_counter()
        for _ in range(n):
            bare()
        t3 = time.perf_counter()
    return {"span_us": (t1 - t0) / n * 1e6,
            "traced_call_us": ((t2 - t1) - (t3 - t2)) / n * 1e6}


def traced_window(cell, seed, seconds):
    import torch
    from av1dec_tpu_torch import tracing
    from av1dec_tpu_torch.ops.kernels import cuda_build
    from pbcore import drive, spans, traffic
    from pbcore import trace as tr
    torch.set_num_threads(int(cell.config["threads"]["torch_intra_op"]))
    units, refs = bench.load_streams(cell)
    n_units = {s: len(u) for s, u in units.items()}
    runner = drive.Runner(cell.config, "cuda", units, refs)
    for c in traffic.warm_calls(cell.traffic, n_units,
                                cell.config.get("batch")):
        runner.call(c, drive.Record(), timed_stages=True)
    torch.cuda.synchronize()
    gen = traffic.calls(cell.traffic, n_units, seed)
    entries = {k: v[0] for k, v in cuda_build.KERNELS.items()}
    # each copy the program counts, by the span open on its thread
    made = {}
    real = tracing._copied

    def copied(kind, nbytes):
        if nbytes and tracing._local.unit is not None:
            st = tracing._local.stack
            key = (kind, st[-1][0] if st else "no span")
            made[key] = made.get(key, 0) + 1
        real(kind, nbytes)
    tracing._copied = copied
    try:
        for i, settle in enumerate(bench.SETTLES):
            made.clear()
            inst = spans.Instrument()
            box = {}

            def body():
                with inst:
                    box["rec"], box["wall"] = bench.window(
                        runner, gen, seconds if i == 0 else 0, True)
            with tracing.collect() as records:
                ev, h0 = tr.profile_calls(body, settle)
            t = tr.read(ev, h0, inst.launches, entries, records)
            log(f"{cell.name}: trace {i + 1} "
                f"{'whole' if t.whole else 'not whole: ' + t.why}")
            if t.whole:
                break
    finally:
        tracing._copied = real
    if not t.whole:
        return {"whole": False, "why": t.why}
    rec = box["rec"]
    main = threading.get_ident()
    (w0, w1), inside, gaps = window_of(ev, h0)
    segs = innermost(records, main)
    calls = sorted((s[2], s[3]) for s in inst.spans
                   if s[0] == "Decoder.decode")
    pw = piecewise(gaps, segs, calls)
    idle = sum(b - a for a, b in gaps)
    ends = [b for _, b in calls]
    in_calls = sum(overlap(a, b, calls, ends) for a, b in gaps)
    below = in_calls - pw.get("decode", 0.0) - pw.get(NO_SPAN, 0.0)
    bench_t = tr.read(ev, h0, inst.launches, entries, inst.spans)
    trace_copies = {}
    starts = [a for a, _, _ in segs]
    for name, s, _ in inside:
        kind = "h2d" if H2D.search(name) else \
            "d2h" if D2H.search(name) else None
        if kind:
            key = (kind, span_at(segs, starts, h0 + (s - w0) / 1e6))
            trace_copies[key] = trace_copies.get(key, 0) + 1
    counted = {k: sum(s[k] for s in rec.stats)
               for k in ("h2d_copies", "d2h_copies")}
    seen = {f"{k}_copies": sum(n for (kk, _), n in trace_copies.items()
                               if kk == k) for k in ("h2d", "d2h")}
    # the always-on cost: a span's bookkeeping for each record, and an
    # accumulated call for each host-path inter block, over the frames'
    # time
    cost = span_cost()
    n = len(rec.stats)
    cost["spans_a_frame"] = len(records) / n
    cost["blocks_a_frame"] = sum(sum(s["inter_blocks"].values())
                                 for s in rec.stats) / n
    cost["share_of_frame"] = (
        cost["span_us"] * cost["spans_a_frame"] +
        cost["traced_call_us"] * cost["blocks_a_frame"]) / 1e3 / (
        sum(s["ms"] + s["spans_ms"].get("parse", 0.0) for s in rec.stats) /
        n)
    return {
        "whole": True, "window_s": t.window_s, "busy_s": t.busy_s,
        "always_on_cost": cost,
        "idle_s": idle, "frames": len(rec.frames),
        "records": len(records),
        "midpoint": t.gaps, "bench_midpoint": bench_t.gaps,
        "piecewise": pw, "inside_calls_s": in_calls,
        "below_decode_s": below,
        "below_decode_share": below / in_calls if in_calls else None,
        "copies": {"counted": counted, "trace": seen,
                   "equal": counted == seen,
                   "counted_by_span": {f"{k} {s}": n for (k, s), n in
                                       sorted(made.items())},
                   "trace_by_span": {f"{k} {s}": n for (k, s), n in
                                     sorted(trace_copies.items())}},
        "split": mean_split(rec.stats),
    }


def collect_cost(cell, seeds, seconds):
    """fps of run_cell(trace=0) without and with tracing.collect(), one
    pair a seed, the order turning each pair."""
    from av1dec_tpu_torch import tracing
    out = {"off": [], "on": []}
    for i, seed in enumerate(seeds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                with tracing.collect() as records:
                    result, _ = bench.run_cell(cell, seed, seconds, 0)
                n = len(records)
            else:
                result, _ = bench.run_cell(cell, seed, seconds, 0)
            if not result["correct"]:
                raise RuntimeError(f"{cell.name}: a run was not correct")
            fps = result["metrics"]["fps"]["value"]
            out["on" if on else "off"].append(fps)
            log(f"{cell.name}: seed {seed} collect "
                f"{'on' if on else 'off'}: {fps:.4f} fps"
                + (f", {n} records" if on else ""))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", nargs="+",
                   default=["inter.device", "inter.host"])
    p.add_argument("--seed", type=int, default=2 ** 33 + 4242)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--runs", type=int, default=3,
                   help="pairs of runs for collect()'s cost (0: none)")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "trace_gaps.json"))
    args = p.parse_args(argv)
    cells = [spec.load_cell(n) for n in args.cells]
    for c in cells:
        if c.config["entry"] != "Decoder":
            raise SystemExit(f"{c.name}: not a Decoder cell")
    bench.set_host(cells[0].config)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    seconds = args.seconds or spec.benchmark()["run_seconds"]
    out = {"card": bench.smi("name,power.limit"),
           "torch": torch.__version__, "seed": args.seed,
           "seconds": seconds, "cells": {}}
    for cell in cells:
        r = traced_window(cell, args.seed, seconds)
        if args.runs:
            r["collect_cost"] = collect_cost(
                cell, [args.seed + 1 + i for i in range(args.runs)],
                seconds)
        out["cells"][cell.name] = r
        log(f"{cell.name}: {json.dumps(r)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for name, r in out["cells"].items():
        if r["whole"]:
            log(f"{name}: idle {r['idle_s']:.3f} s of {r['window_s']:.3f};"
                f" inside calls {r['inside_calls_s']:.3f} s, below decode "
                f"{100 * (r['below_decode_share'] or 0):.2f} %; copies "
                f"{r['copies']['counted']} vs trace {r['copies']['trace']}"
                f" equal {r['copies']['equal']}")
    return 0 if all(r["whole"] and r["copies"]["equal"]
                    for r in out["cells"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
