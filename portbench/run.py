"""The port's benchmark: one run of one cell on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration (its file
under `portbench/configs/`: the port's entry, its settings and the host
threads) and a traffic mix (`portbench/traffic/<traffic>.json`).  The run
sets the host threads, loads the committed streams, warms up one call of
each stream (set-up), then calls the entry in a closed loop, one client,
for `--seconds`: the window closes when the first round of calls (each
stream of the mix once) that ends after that returns, and its frames
count.  Every frame handed back is held to
libaom's MD5 (`portbench/reference/`).  `--trace 0` prints the cell's
end-to-end metrics, `--trace 1` its per-layer metrics, from a
torch.profiler trace of the window and the program's own stage clocks
and stats.  The last line of standard output is the result's JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error.  Without a CUDA card, or with fewer than the cell asks
for, the run exits with code 2 and prints no result."""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

T_START = time.monotonic()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from pbcore import spec  # noqa: E402  (standard library only)

FORBIDDEN = ("jax", "jaxlib", "flax", "av1dec_tpu")
# settle seconds before each traced window, the main one first
SETTLES = (2.0, 4.0, 8.0, 16.0)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def set_host(config):
    """The host threads of the configuration, set before NumPy and torch
    are imported, and the build and kernel caches inside the checkout."""
    n = str(int(config["threads"]["blas"]))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = n
    cache = os.path.join(spec.ROOT, "build", "portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    if spec.ROOT not in sys.path:
        sys.path.insert(1, spec.ROOT)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def load_reader(name):
    path = spec.metric_path(name)
    s = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                               path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def smi(query):
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


class Run:
    """What the metric readers read (`portbench/metrics/*.py`)."""
    frames = 0            # frames handed back in the window
    window_s = 0.0        # the window's length, host clock
    setup_s = 0.0
    record = None         # drive.Record of the window
    trace = None          # trace.Trace of the traced (sub)window
    trace_frames = 0      # frames of the traced (sub)window
    bound_s = None        # kernel -> bound seconds of the traced launches
    memory_peak_bytes = 0


CHROMA = {"4:2:0": [1, 1], "4:2:2": [1, 0], "4:4:4": [0, 0]}


def load_streams(cell):
    """The mix's streams (stream -> temporal units) and libaom's record
    of each; each stream is the one its record was made from, in the
    configuration's picture format."""
    from pbcore.drive import read_ivf
    import hashlib
    fmt = cell.config["format"]
    units, refs = {}, {}
    for s in cell.traffic["streams"]:
        path = spec.stream_path(s)
        with open(path, "rb") as f:
            data = f.read()
        ref = spec.reference(s)
        if hashlib.sha256(data).hexdigest() != ref["sha256"]:
            raise RuntimeError(f"{path} is not the stream libaom's record "
                               f"was made from")
        have = (ref["width"], ref["height"], ref["bit_depth"],
                list(ref["subsampling"]), ref["mono"])
        want = (fmt["width"], fmt["height"], fmt["bit_depth"],
                CHROMA[fmt["chroma"]], False)
        if have != want:
            raise RuntimeError(f"{s} is {have}, the configuration's "
                               f"format is {want}")
        units[s] = read_ivf(path)
        refs[s] = ref
    return units, refs


def compare(frames):
    """The numbers compared, each with its limit: frames whose MD5 is not
    libaom's (or that libaom does not show), and frames never handed
    back."""
    wrong = sum(f.got is not None and f.got != f.want for f in frames)
    missing = sum(f.got is None for f in frames)
    return {"frames_wrong": {"value": wrong, "limit": 0},
            "frames_missing": {"value": missing, "limit": 0},
            "frames_checked": {"value": len(frames), "limit": 1}}


def correct_of(checks):
    return (checks["frames_wrong"]["value"] <= 0 and
            checks["frames_missing"]["value"] <= 0 and
            checks["frames_checked"]["value"] >= 1)


def cpu_s():
    """The process's CPU seconds (user and system, every thread)."""
    t = os.times()
    return t.user + t.system


def window(runner, gen, seconds, timed_stages=False):
    """Calls in a closed loop until the first round of calls (each
    stream of the mix once) that ends after `seconds`; (record, seconds
    it took)."""
    from pbcore.drive import Record
    rec = Record()
    t0 = t = time.monotonic()
    cpu = cpu_s()
    while True:
        call = next(gen)
        runner.call(call, rec, timed_stages)
        now, cpu_now = time.monotonic(), cpu_s()
        rec.call_s.append(now - t)
        rec.call_cpu_s.append(cpu_now - cpu)
        t, cpu = now, cpu_now
        if call.last and now - t0 >= seconds:
            return rec, now - t0


def run_cell(cell, seed, seconds, trace, device=None):
    """One run of `cell` on the configuration's `device` (or `device`):
    (the result's object, `checks` last; the calls the seed drew).  On
    "cpu" (tests) no trace is taken.  Raises SystemExit when JAX or the
    JAX package was loaded."""
    import torch
    device = device or cell.config["device"]
    torch.set_num_threads(int(cell.config["threads"]["torch_intra_op"]))
    from pbcore import drive, traffic
    units, refs = load_streams(cell)
    n_units = {s: len(u) for s, u in units.items()}
    runner = drive.Runner(cell.config, device, units, refs)
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    scratch = drive.Record()
    for c in traffic.warm_calls(cell.traffic, n_units,
                                cell.config.get("batch")):
        runner.call(c, scratch, timed_stages=trace)
    sync()
    del scratch
    gen = traffic.calls(cell.traffic, n_units, seed)
    run = Run()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_open = time.monotonic()
    run.setup_s = t_open - T_START
    traced_calls = []
    extra = []   # frames of traced sub-windows, also compared
    if trace and on_card:
        from pbcore import spans, trace as tr
        from av1dec_tpu_torch.ops.kernels import cuda_build
        entries = {k: v[0] for k, v in cuda_build.KERNELS.items()}
        inst = spans.Instrument()
        box = {}

        def body():
            with inst:
                box["rec"], box["wall"] = window(runner, gen, seconds, True)
        ev, h0 = tr.profile_calls(body, SETTLES[0])
        run.record, run.window_s = box["rec"], box["wall"]
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        t = tr.read(ev, h0, inst.launches, entries, inst.spans)
        traced_calls, run.trace_frames = run.record.calls, \
            len(run.record.frames)
        log(f"trace of the window: "
            f"{'whole' if t.whole else 'not whole: ' + t.why}")
        for settle in SETTLES[1:]:
            if t.whole:
                break
            sub = spans.Instrument()
            box = {}

            def one():
                with sub:
                    box["rec"], _ = window(runner, gen, 0)
            ev, h0 = tr.profile_calls(one, settle)
            t = tr.read(ev, h0, sub.launches, entries, sub.spans)
            extra += box["rec"].frames
            traced_calls, run.trace_frames = box["rec"].calls, \
                len(box["rec"].frames)
            log(f"trace of one more call, {settle} s after the profiler "
                f"started: {'whole' if t.whole else 'not whole: ' + t.why}")
        if not t.whole:
            timer = tr.EventTimer()
            sub = spans.Instrument(spans=False, on_launch=timer)
            with sub:
                rec, wall = window(runner, gen, 0)
            extra += rec.frames
            traced_calls, run.trace_frames = rec.calls, len(rec.frames)
            t = timer.trace(wall)
            log("kernels timed from CUDA events around each launch of one "
                "more call instead; no device idle share, no copies")
        run.trace = t
    else:
        run.record, run.window_s = window(runner, gen, seconds, trace)
        if on_card:
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    run.frames = len(run.record.frames)
    if run.trace is not None:
        from pbcore import work
        rec = drive.Record()
        try:
            with work.Recorder() as w:
                for c in traced_calls:
                    runner.call(c, rec)
            if w.calls == run.trace.kernel_n:
                run.bound_s = w.bound
            else:
                log(f"NO ROOFLINE: the bound pass launched {w.calls}, the "
                    f"trace holds {run.trace.kernel_n}")
        except work.LayoutChanged as e:
            log(f"NO ROOFLINE: {e}")
        del rec
    checks = compare(run.record.frames + extra)
    metrics = cell.per_layer if trace else cell.end_to_end
    out = {}
    for m in metrics:
        v = load_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct_of(checks),
              "attempted": checks["frames_checked"]["value"],
              "failed": checks["frames_wrong"]["value"] +
              checks["frames_missing"]["value"],
              "metrics": out}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": run.memory_peak_bytes,
           "power_limit": smi("power.limit") if on_card else "none"}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result["device"] = dev
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.ops,
                               "idle_gaps": run.trace.gaps}
    rec = run.record
    result["recon_paths"] = {"expected": rec.paths_want,
                             "taken": rec.paths_took,
                             "off_path": rec.off_path}
    result["checks"] = checks
    draws = [[c.stream, list(c.units), round(s, 3), round(u, 3)]
             if cell.traffic["call"] == "frames" else
             [c.stream, round(s, 3), round(u, 3)]
             for c, s, u in zip(rec.calls, rec.call_s, rec.call_cpu_s)]
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of {found} were loaded: the port's "
                         f"benchmark runs without JAX and the JAX package")
    return result, draws


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    set_host(cell.config)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"no result: the cell needs {cell.chips} CUDA card(s); torch "
            f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"cell {cell.name}: seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}; host threads: torch intra-op "
        f"{cell.config['threads']['torch_intra_op']}, BLAS "
        f"{cell.config['threads']['blas']}, decoder "
        f"{cell.config['threads']['decoder']}, nproc {os.cpu_count()}; "
        f"card {smi('name,power.limit')}; torch {torch.__version__}")
    result, draws = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace))
    log(f"draws (stream, units, call seconds, the process's CPU seconds "
        f"in the call): {json.dumps(draws)}")
    paths = result["recon_paths"]
    log(f"frames by recon path: expected {paths['expected']}, taken "
        f"{paths['taken']}; {paths['off_path']} off their expected path")
    for k, v in result["checks"].items():
        bound = "at least" if k == "frames_checked" else "at most"
        log(f"check {k}: {v['value']} ({bound} {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
