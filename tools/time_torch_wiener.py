"""Time the port's device Wiener pass (B5, `ops/kernels/lr.wiener_plane`)
on the card, on the planes of `bench_1080p_host_cq40`'s key frame, and
optionally against another checkout's `wiener_plane` on the same inputs.

    python3 tools/time_torch_wiener.py [--other DIR] [--iters N]

The key frame is decoded with `Decoder(device="cuda")` (its MD5 is held
to the manifest) while each `wiener_plane` call's inputs are kept.  For
each version (this tree's, and `DIR/av1dec_tpu_torch/ops/kernels/lr.py`
with --other) it prints, per frame (all Wiener planes), the device
milliseconds and kernels (torch.profiler), the wrapper-inclusive
milliseconds (CUDA events), and the pixels that differ from this tree's
output, in the order other, this, this, other; then the bytes bound and
the card's name and power limit, and a JSON line with all of it.
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
    """(cdef plane, pre-CDEF plane, args, bd) of each `wiener_plane` call
    of the key frame's decode, which is held to the manifest."""
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.ops.kernels import lr
    with open(os.path.join(cs.TESTDATA, "manifest.json")) as f:
        want = json.load(f)[STREAM]["frames"][:1]
    calls = []
    real = lr.wiener_plane

    def keep(cdef_p, pre_p, args, bd):
        calls.append((cdef_p.clone(), pre_p.clone(),
                      tuple(a.clone() for a in args), bd))
        return real(cdef_p, pre_p, args, bd)
    lr.wiener_plane = keep
    try:
        dec = api.Decoder(device=dev)
        got = [f.display_md5() for f in dec.decode(cs.read_tus(STREAM)[0])]
        dec.close()
    finally:
        lr.wiener_plane = real
    if got != want or not calls:
        raise AssertionError(f"{STREAM} TU 0: equal to the manifest "
                             f"{got == want}, Wiener calls {len(calls)}")
    return calls


def wiener_bytes(calls):
    """Bytes the pass must move: the post-CDEF plane read once, the
    pre-CDEF rows that some tap reads, the output written once."""
    n = 0
    for cdef_p, pre_p, args, _ in calls:
        vr, inside = args[5], args[6]
        pre_rows = torch.unique(vr[~inside]).numel()
        n += cdef_p.numel() * cdef_p.element_size() + \
            pre_rows * pre_p.shape[1] * pre_p.element_size() + \
            cdef_p.numel() * 4
    return n


def time_version(fn, calls, iters):
    def run():
        return [fn(*c) for c in calls]
    dev_ms, kernels = cs.device_ms(run, iters)
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
    calls = key_frame_inputs(torch.device("cuda"))
    versions = {"this": lr.wiener_plane}
    order = ["this", "this"]
    if a.other:
        versions["other"] = other_checkout.load(
            a.other, "av1dec_tpu_torch.ops.kernels.lr", "other").wiener_plane
        order = ["other", "this", "this", "other"]
    ref = [versions["this"](*c) for c in calls]
    runs = []
    for name in order:
        t, outs = time_version(versions[name], calls, a.iters)
        t["version"] = name
        t["differing_px"] = sum(int((o != r).sum())
                                for o, r in zip(outs, ref))
        cs.log(json.dumps(t))
        runs.append(t)
    nbytes = wiener_bytes(calls)
    bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
    card = cs.card_line()
    cs.log(json.dumps({"wiener_pass": {
        "stream": f"{STREAM} TU 0", "planes": [tuple(c[0].shape)
                                               for c in calls],
        "runs": runs, "bytes": nbytes, "bound_ms": bound_ms,
        "bound_by": "bytes", "card": card}}))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
