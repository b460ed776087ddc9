"""Time the device postfilter stage (`_postfilter_chain`: deblock, CDEF,
superres, Wiener LR and the narrowing cast, with its host half) on the
committed 1080p streams, with the package of this tree or of another
checkout.

    python3 tools/time_torch_postfilter.py [--root DIR] [--passes N]

`--root DIR` imports `av1dec_tpu_torch` from DIR (e.g. the parent commit
unpacked with `git archive` into `build/parent`), so that one call can
time two versions in turns (parent, change, change, parent).  For each
stream, after one warm decode, N decodes with the host clock around
each postfilter call, the device synchronised before and after it
(`chip_smoke.postfilter_clocked`): the
all-intra stream through `decode_stream_batched` (its `postfilter`
stage), the low-delay inter and the compound stream through
`Decoder(device="cuda")`, and the cq-40 host stream's key frame (device
Wiener LR) through `Decoder`.  Every decoded frame's MD5 is held to the
manifest.  Prints one JSON line a stream (mean ms a frame of each pass)
and the card's name and power limit.
"""
import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402

TESTDATA = os.path.join(_REPO, "av1dec_tpu_torch", "testdata")
# (stream, TUs decoded or None for all, route)
STREAMS = (("bench_1080p_intra", None, "batched"),
           ("bench_1080p_inter", None, "decoder"),
           ("bench_1080p_compound", None, "decoder"),
           ("bench_1080p_host_cq40", 1, "decoder"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=_REPO,
                    help="the checkout whose package is timed")
    ap.add_argument("--passes", type=int, default=3)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    if not torch.cuda.is_available():
        print("time_torch_postfilter: no CUDA device", file=sys.stderr)
        return 1
    from av1dec_tpu_torch import api, bindings
    from av1dec_tpu_torch.container import read_ivf
    from av1dec_tpu_torch.ops.kernels import cuda_build
    bindings.build_native()
    cuda_build.build_kernels()
    with open(os.path.join(TESTDATA, "manifest.json")) as f:
        manifest = json.load(f)
    card = cs.card_line()
    for name, count, route in STREAMS:
        tus = [d for _, d in read_ivf(os.path.join(TESTDATA,
                                                   name + ".ivf"))][:count]
        want = manifest[name]["frames"][:count]
        if route == "batched":
            def run():
                tm = {}
                out = api.decode_stream_batched(tus, device="cuda", batch=4,
                                                timings=tm)
                got = [api.display_md5(p, 8, 1920, 1080, (1, 1))
                       for p in out]
                return got, tm["postfilter"] * 1e3 / len(out)
        else:
            def run():
                def decode():
                    dec = api.Decoder(device="cuda")
                    got = [f.display_md5() for tu in tus
                           for f in dec.decode(tu)]
                    dec.close()
                    return got
                return cs.postfilter_clocked(decode)
        run()
        ms = []
        for _ in range(a.passes):
            got, m = run()
            if got != want:
                raise AssertionError(f"{name}: frames differ from the "
                                     f"manifest")
            ms.append(m)
        print(json.dumps({"root": a.root, "stream": name,
                          "frames": len(want),
                          "postfilter_ms_per_frame": ms, "card": card}),
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
