"""Time the port's device Wiener pass (B5, `ops/kernels/lr.lr_wiener_planes`:
on the card the kernel `csrc/wiener.cu`) on the planes of
`bench_1080p_host_cq40`'s key frame, beside its plain version and
optionally beside another checkout's `lr_wiener_planes` on the same
inputs.

    python3 tools/time_torch_wiener.py [--other DIR] [--iters N]

The key frame is decoded with `Decoder(device="cuda")` (its MD5 is held
to the manifest) while its `lr_wiener_planes` call's inputs are kept.
For each version (this tree's, its plain version `_wiener_plain`, and
`DIR/av1dec_tpu_torch/ops/kernels/lr.py` with --other) it prints the
device milliseconds and kernels a call (torch.profiler), the
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
sys.path.insert(0, _REPO)

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


def time_version(fn, call, iters):
    def run():
        return fn(*call)
    dev_ms, kernels, _ = cs.all_events(run, iters, "wiener_kernel")
    return {"device_ms": dev_ms, "kernels": kernels,
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
    call = key_frame_inputs(torch.device("cuda"))
    versions = {"this": lr.lr_wiener_planes, "plain": lr._wiener_plain}
    order = ["this", "plain", "this"]
    if a.other:
        versions["other"] = other_checkout.load(
            a.other, "av1dec_tpu_torch.ops.kernels.lr",
            "other").lr_wiener_planes
        order = ["other"] + order + ["other"]
    ref = lr._wiener_plain(*call)
    runs = []
    for name in order:
        t, outs = time_version(versions[name], call, a.iters)
        t["version"] = name
        t["differing_px"] = sum(int((o != r).sum())
                                for o, r in zip(outs, ref))
        cs.log(json.dumps(t))
        runs.append(t)
    card = cs.card_line()
    cs.log(json.dumps({"wiener_pass": {
        "stream": f"{STREAM} TU 0",
        "planes": [tuple(p.shape) for p, x in zip(call[0], call[2])
                   if x is not None],
        "runs": runs, **cs.bound_terms(cs.int32_ops_per_s(),
                                       *cs.wiener_work(*call[:3])),
        "card": card}}))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
