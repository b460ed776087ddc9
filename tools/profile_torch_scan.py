"""Where the device time of av1dec_tpu_torch's main path goes, on one card.

    python3 tools/profile_torch_scan.py [--frames 4] [--stages scan,postfilter]

Decodes the first batch (`--frames`) of the committed 1080p all-intra
stream as `decode_stream_batched` does, then, for the wavefront scan and
for the postfilter of that batch:

- the host wall time of the stage, ended by `torch.cuda.synchronize()`,
  without the profiler (best of three);
- under `torch.profiler`: the device kernels launched, their summed
  device time, the union of their device intervals ("busy"), and the
  busy share of the unprofiled wall time; the five kernels with the most
  device time.

Prints one JSON object per stage named in `--stages` (both by default)
and the card's name and power limit.
Needs a CUDA card; exits non-zero without one.
"""
import json
import os
import subprocess
import sys
import time

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _busy_us(intervals):
    """Length of the union of [start, end) intervals, in us."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _wall_ms(fn):
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t) * 1e3)
    return best


def _profile(name, fn, extra):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    wall = _wall_ms(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise RuntimeError(f"{name}: the profiler recorded no device "
                           f"kernel")
    iv = [(e.time_range.start, e.time_range.end) for e in kern]
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    busy = _busy_us(iv) / 1e3
    print(json.dumps(dict({
        "stage": name, "wall_ms": wall, "kernels": len(kern),
        "kernel_ms_sum": sum(e.time_range.elapsed_us() for e in kern) / 1e3,
        "busy_ms": busy, "busy_share": busy / wall,
        "top": [{"kernel": k[:80], "launches": n, "ms": t / 1e3}
                for k, (n, t) in top]}, **extra)), flush=True)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--stages", default="scan,postfilter")
    args = ap.parse_args()
    stages = args.stages.split(",")
    if not torch.cuda.is_available():
        print("profile_torch_scan: no CUDA device", file=sys.stderr)
        return 1
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.pipeline.device_recon import (DeviceRecon,
                                                        postfilter_batch,
                                                        prep_batch,
                                                        scan_batch,
                                                        to_torch_inputs)
    path = os.path.join(_REPO, "av1dec_tpu_torch", "testdata",
                        "bench_1080p_intra.ivf")
    parser = NativeParser()
    drs = []
    for _, tu in read_ivf(path):
        for hdr, plans in parser.parse_tu(tu, with_plans=True):
            drs.append(DeviceRecon(parser.seq, hdr, plans))
        if len(drs) >= args.frames:
            break
    parser.close()
    drs = drs[:args.frames]
    inputs = to_torch_inputs(prep_batch(drs), "cuda")
    ws, wc, _ = inputs["windows"]
    extra = {"frames": len(drs), "windows": int(ws.shape[0]),
             "window_buckets": int((wc > 0).sum())}
    frame = scan_batch(inputs)
    if "scan" in stages:
        _profile("scan", lambda: scan_batch(inputs), extra)
    if "postfilter" in stages:
        _profile("postfilter", lambda: postfilter_batch(drs, inputs, frame),
                 {"frames": len(drs)})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
