"""Where the device time of av1dec_tpu_torch's main path goes, on one card.

    python3 tools/profile_torch_scan.py [--frames 4] \
        [--stages scan,scan_plain,postfilter] [--other DIR ...]

Decodes the first batch (`--frames`) of the committed 1080p all-intra
stream as `decode_stream_batched` does, then, for each stage of that
batch: `scan`, the wavefront scan as the decode runs it (the kernel
`csrc/wavefront_scan.cu`, one persistent launch for the batch);
`scan_plain`, its plain version (`_scan_plain`, the eager window loop)
on the same inputs; and `postfilter`.  With `--other`, the scan of each
other checkout (its `ops/kernels/wavefront.py` and `cuda_build.py`,
loaded under their own names with `tools/other_checkout.py`, its kernel
built into its own build directory; e.g. the parent commit unpacked with
`git archive`, whose route is one launch per level) runs beside this
tree's on the same buffer after the MC pass, in the order others, this,
this, others reversed (stages `scan <tag>`), each with the pixels that
differ from this tree's scan.  For each stage:

- the host wall time of the stage, ended by `torch.cuda.synchronize()`,
  without the profiler (best of three);
- under `torch.profiler`: the device kernels launched, their summed
  device time, the union of their device intervals ("busy"), and the
  busy share of the unprofiled wall time; the five kernels with the most
  device time.

Prints one JSON object per stage named in `--stages` (`scan` and
`postfilter` by default) and the card's name and power limit.
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

import other_checkout  # noqa: E402

_KERNELS = "av1dec_tpu_torch.ops.kernels"


class Version:
    """The scan route of the checkout at `root` (None: this tree)."""

    def __init__(self, root, tag):
        from av1dec_tpu_torch.ops.kernels import cuda_build, wavefront
        self.tag = tag
        if root is None:
            self.wf, self.build = wavefront, cuda_build
        else:
            self.wf = other_checkout.load(root, _KERNELS + ".wavefront",
                                          tag)
            self.build = other_checkout.load(
                root, other_checkout.BUILD_MOD, tag)
        self.build.build_kernels()

    def active(self):
        """This version's `cuda_build` in place of the tree's."""
        return other_checkout.kernels_of(self.build)

    def route(self, inputs, frame):
        """A function of no argument that runs this version's scan of the
        batch on `frame` in place.  Its level plan comes from its own
        `plan_levels`, with the table its kernel reads on the card: the
        level table of a launch-per-level route (which returns the table
        and the lanes), the ticket table of the persistent one (which
        returns a third array, the tickets)."""
        import numpy as np
        buckets = inputs["config"][0]
        table = inputs["levels"][0]
        ts = [t for t, _ in buckets]
        plan = self.wf.plan_levels(
            {t: table[:, bi, 0] for bi, t in enumerate(ts)},
            {t: table[:, bi, 1] for bi, t in enumerate(ts)}, ts)
        levels = tuple(plan) + (torch.as_tensor(
            np.ascontiguousarray(plan[2] if len(plan) == 3 else plan[0]),
            device=frame.device),)
        args = (inputs["packed"], inputs["res"], inputs["pal"],
                inputs["config"], inputs["windows"], levels)
        return lambda: self.wf.scan_into(frame, *args)


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


def _profile(name, fn, extra, wrapper=None):
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
    scan = [e for e in kern if "wavefront" in e.name]
    out = dict({
        "stage": name, "wall_ms": wall, "kernels": len(kern),
        "kernel_ms_sum": sum(e.time_range.elapsed_us() for e in kern) / 1e3,
        "scan_kernels": len(scan),
        "scan_kernel_ms": sum(e.time_range.elapsed_us() for e in scan) /
        1e3, "busy_ms": busy, "busy_share": busy / wall,
        "top": [{"kernel": k[:80], "launches": n, "ms": t / 1e3}
                for k, (n, t) in top]}, **extra)
    if wrapper is not None:
        out["wrapper_ms"] = wrapper()
    print(json.dumps(out), flush=True)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--stages", default="scan,postfilter")
    ap.add_argument("--other", action="append", default=[],
                    help="a checkout whose scan is timed beside this "
                    "tree's (may be given more than once)")
    args = ap.parse_args()
    stages = args.stages.split(",")
    if not torch.cuda.is_available():
        print("profile_torch_scan: no CUDA device", file=sys.stderr)
        return 1
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.ops.kernels.wavefront import _scan_plain
    from av1dec_tpu_torch.pipeline.device_recon import (DeviceRecon,
                                                        batch_residuals,
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
    # the residuals once, so that each profile times the scan alone
    inputs["res"] = batch_residuals(inputs)
    ws, wc, _ = inputs["windows"]
    extra = {"frames": len(drs), "windows": int(ws.shape[0]),
             "window_buckets": int((wc > 0).sum()),
             "levels": int((inputs["levels"][1] > 0).sum())}
    frame = scan_batch(inputs)
    if "scan" in stages:
        _profile("scan", lambda: scan_batch(inputs), extra)
    if args.other:
        import chip_smoke as cs
        this = Version(None, "this")
        others = [Version(root, f"other{i}")
                  for i, root in enumerate(args.other)]
        base = cs.mc_frame(inputs)
        for v in others + [this, this] + others[::-1]:
            got = base.clone()
            fn = v.route(inputs, got)
            with v.active():
                _profile(f"scan {v.tag}", fn, extra,
                         lambda: cs.cuda_ms(fn, 20))
                got.copy_(base)
                fn()
            torch.cuda.synchronize()
            print(json.dumps({"version": v.tag, "differing_px": int(
                (got[:-1] != frame).sum())}), flush=True)
    if "scan_plain" in stages:
        plain = frame.clone()
        _profile("scan_plain", lambda: _scan_plain(
            plain, inputs["packed"], inputs["res"], inputs["pal"],
            inputs["config"], inputs["windows"]), extra)
    if "postfilter" in stages:
        _profile("postfilter", lambda: postfilter_batch(drs, inputs, frame),
                 {"frames": len(drs)})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
