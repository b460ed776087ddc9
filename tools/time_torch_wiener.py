"""Time the port's device Wiener pass (B5, `ops/kernels/lr.lr_wiener_planes`:
on the card the kernel `csrc/wiener.cu`) on the planes of
`bench_1080p_host_cq40`'s key frame and on a seeded 1080p 4:2:0 12-bit
frame (three planes, units of 256 and 128, 20 % off, seed 3), beside its
plain version and optionally beside another checkout's
`lr_wiener_planes` on the same inputs.

    python3 tools/time_torch_wiener.py [--other DIR] [--iters N]

The key frame is decoded with `Decoder(device="cuda")` (its MD5 is held
to the manifest) while its `lr_wiener_planes` call's inputs are kept.
For each input and version (this tree's, its plain version `_wiener_plain`, and
`DIR/av1dec_tpu_torch/ops/kernels/lr.py` with --other, bound to that
checkout's own `cuda_build.py` and kernels, built into its own build
directory with `tools/other_checkout.py`) it prints the
device milliseconds and kernels a call and the `wiener_kernel`
intervals' milliseconds (torch.profiler), the
wrapper-inclusive milliseconds (CUDA events) and the pixels that differ
from this tree's plain output, in the order other, this, plain, this,
other; then the bound (bytes and operations, `chip_smoke.wiener_work`)
and the card's name and power limit, and a JSON line with all of it.
"""
import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_REPO, os.path.join(_REPO, "tests")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import other_checkout  # noqa: E402

STREAM = "bench_1080p_host_cq40"


def key_frame_inputs(dev):
    """The arguments (planes, pre-CDEF planes, lr_args, bd) of the key
    frame's `lr_wiener_planes` call, whose decode is held to the
    manifest."""
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.pipeline import device_recon
    with open(os.path.join(cs.TESTDATA, "manifest.json")) as f:
        want = json.load(f)[STREAM]["frames"][:1]
    calls = []
    real = device_recon.lr_wiener_planes

    def keep(*args):
        calls.append(args)
        return real(*args)
    device_recon.lr_wiener_planes = keep
    try:
        dec = api.Decoder(device=dev)
        got = [f.display_md5() for f in dec.decode(cs.read_tus(STREAM)[0])]
        dec.close()
    finally:
        device_recon.lr_wiener_planes = real
    if got != want or len(calls) != 1:
        raise AssertionError(f"{STREAM} TU 0: equal to the manifest "
                             f"{got == want}, Wiener calls {len(calls)}")
    return calls[0]


def seeded_inputs(dev):
    """The arguments of a seeded 1080p 4:2:0 12-bit frame's Wiener pass,
    all three planes with units (as `chip_smoke.phase_postfilter` makes
    them)."""
    import numpy as np
    from torch_port_helpers import seeded_wiener_args, smooth_plane
    rng = np.random.default_rng(3)
    bd = 12

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    cdef_p, pre_p, args = [], [], []
    for plane in range(3):
        a, _, _ = seeded_wiener_args(rng, 1920, 1080, [256, 128, 128], plane)
        h, w = len(a[0]), len(a[1])
        cdef_p.append(t(smooth_plane(rng, h, w, bd, 40 << (bd - 8))))
        pre_p.append(t(smooth_plane(rng, h, w, bd, 40 << (bd - 8))))
        args.append(tuple(t(x) for x in a))
    return cdef_p, pre_p, args, bd


def time_version(fn, call, iters):
    def run():
        return fn(*call)
    dev_ms, kernels, k_ms = cs.traced(run, "wiener_kernel", iters,
                                      one_each=False)
    return {"device_ms": dev_ms, "kernels": kernels, "kernel_ms": k_ms,
            "wrapper_ms": cs.cuda_ms(run, iters)}, run()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="a checkout whose wiener_plane is "
                    "timed beside this tree's")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_wiener: no CUDA device", file=sys.stderr)
        return 1
    from av1dec_tpu_torch import bindings
    from av1dec_tpu_torch.ops.kernels import cuda_build, lr
    bindings.build_native()
    cuda_build.build_kernels()
    dev = torch.device("cuda")
    inputs = {f"{STREAM} TU 0": key_frame_inputs(dev),
              "seeded 1080p 4:2:0 12-bit": seeded_inputs(dev)}
    versions = {"this": lr.lr_wiener_planes, "plain": lr._wiener_plain}
    order = ["this", "plain", "this"]
    if a.other:
        build = other_checkout.load(a.other, other_checkout.BUILD_MOD,
                                    "other")
        with other_checkout.kernels_of(build):
            versions["other"] = other_checkout.load(
                a.other, "av1dec_tpu_torch.ops.kernels.lr",
                "other").lr_wiener_planes
        build.build_kernels(["wiener"])
        order = ["other"] + order + ["other"]
    card = cs.card_line()
    for what, call in inputs.items():
        ref = lr._wiener_plain(*call)
        runs = []
        for name in order:
            t, outs = time_version(versions[name], call, a.iters)
            t["version"] = name
            t["differing_px"] = sum(int((o != r).sum())
                                    for o, r in zip(outs, ref))
            cs.log(json.dumps({"input": what, **t}))
            runs.append(t)
        cs.log(json.dumps({"wiener_pass": {
            "stream": what,
            "planes": [tuple(p.shape) for p, x in zip(call[0], call[2])
                       if x is not None],
            "runs": runs, **cs.bound_terms(cs.int32_ops_per_s(),
                                           *cs.wiener_work(*call[:3])),
            "card": card}}))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
