"""Time the port's deblock kernel (B3, `ops/kernels/deblock.deblock_planes`:
on the card `csrc/deblock.cu`) on three 1080p 4:2:0 8-bit inputs, and
optionally another checkout's `deblock_planes` on the same inputs.

    python3 tools/time_torch_deblock.py [--other DIR] [--iters N]

Inputs:
- `tx`: a seeded frame whose maps follow the transform sizes, as a
  stream's do (`torch_port_helpers.seeded_deblock(..., "tx")`, seed 1);
- `stress`: a seeded frame whose maps have every length beside every
  other (`seeded_deblock(..., "fit")`, seed 2);
- `stream`: frame 0 of `bench_1080p_intra_lf`, its planes and maps as
  `decode_stream_batched(device="cuda")` gives them to `deblock_planes`
  (the frame's MD5 held to the manifest).
The seeded planes are views of wider buffers, read through their row
stride, as the stream's are.

A checkout's kernel is its `ops/kernels/deblock.py` and its
`cuda_build.py`, loaded under their own names with
`tools/other_checkout.py` (the wrapper binds its own checkout's launch
helper) and built into its own build directory (e.g. the parent commit
unpacked with `git archive` into `build/parent`).  For each input, in
the order other, this, this, other, it prints the device ms of one call
(torch.profiler: the intervals of its `deblock_kernel` launches), every
device interval's ms, the wrapper-inclusive ms (CUDA events), the
launches a call and the pixels that differ from this tree's plain
version `_deblock_plain` (0 expected); then the input's bound (bytes and
operations, `chip_smoke.deblock_work`), the card's name and power limit,
and a JSON line with all of it.  This tree's kernel is built with
`-Xptxas -v`, whose report is printed.  Needs a CUDA card; exits
non-zero without one.
"""
import argparse
import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_REPO, os.path.join(_REPO, "tests")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import other_checkout  # noqa: E402

_DEBLOCK = "av1dec_tpu_torch.ops.kernels.deblock"


def versions(other):
    """{name: (deblock module, cuda_build module)}: this tree's, and with
    `other` that checkout's, its wrapper bound to its own launch
    helper; each kernel built."""
    from av1dec_tpu_torch.ops.kernels import cuda_build, deblock
    out = {"this": (deblock, cuda_build)}
    if other:
        build = other_checkout.load(other, other_checkout.BUILD_MOD,
                                    "other")
        with other_checkout.kernels_of(build):
            out["other"] = (other_checkout.load(other, _DEBLOCK, "other"),
                            build)
    for name, (_, build) in out.items():
        build.build_kernels(["deblock"], verbose=name == "this")
    return out


def seeded(kind, seed, dev):
    """A seeded 1080p 4:2:0 8-bit frame's `deblock_planes` arguments."""
    from torch_port_helpers import seeded_deblock
    rng = np.random.default_rng(seed)
    bases, planes, maps = seeded_deblock(rng, 1080, 1920, "420", 8, kind)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return (tuple(t(b)[:p.shape[0], :p.shape[1]]
                  for b, p in zip(bases, planes)),
            tuple(tuple(tuple(t(m) for m in pair) for pair in pm)
                  for pm in maps), 0, 8)


def stream_frame(dev):
    """The `deblock_planes` arguments of frame 0 of BIG_LF, whose decode
    is held to the manifest."""
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.pipeline import device_recon
    with open(os.path.join(cs.TESTDATA, "manifest.json")) as f:
        want = json.load(f)[cs.BIG_LF]["frames"][:1]
    seen = []
    real = device_recon.deblock_planes

    def keep(*args):
        seen.append(args)
        return real(*args)
    device_recon.deblock_planes = keep
    try:
        out = api.decode_stream_batched(cs.read_tus(cs.BIG_LF)[:1],
                                        device=dev, batch=1)
    finally:
        device_recon.deblock_planes = real
    got = [api.display_md5(p, 8, 1920, 1080, (1, 1)) for p in out]
    if got != want or len(seen) != 1:
        raise SystemExit(f"{cs.BIG_LF} frame 0: equal to the manifest "
                         f"{got == want}, deblock calls {len(seen)}")
    return seen[0]


def time_version(mod, args, ref, iters):
    def run():
        return mod.deblock_planes(*args)
    before = mod.launches
    outs = run()
    launches = mod.launches - before
    dev_ms, kernels, k_ms = cs.traced(run, "deblock_kernel", iters,
                                      one_each=False)
    return {"kernel_ms": k_ms, "device_ms": dev_ms, "kernels": kernels,
            "wrapper_ms": cs.cuda_ms(run, iters), "launches": launches,
            "differing_px": sum(int((o != r).sum())
                                for o, r in zip(outs, ref))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="a checkout whose deblock_planes is "
                    "timed beside this tree's")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_deblock: no CUDA device", file=sys.stderr)
        return 1
    from av1dec_tpu_torch import bindings
    from av1dec_tpu_torch.ops.kernels import deblock
    bindings.build_native()
    vers = versions(a.other)
    order = ["other", "this", "this", "other"] if a.other else ["this"] * 2
    dev = torch.device("cuda")
    inputs = {"tx": seeded("tx", 1, dev), "stress": seeded("fit", 2, dev),
              "stream": stream_frame(dev)}
    card = cs.card_line()
    int_rate = cs.int32_ops_per_s()
    for what, args in inputs.items():
        ref = deblock._deblock_plain(*args)
        runs = []
        for name in order:
            t = time_version(vers[name][0], args, ref, a.iters)
            t["version"] = name
            cs.log(json.dumps({"input": what, **t}))
            runs.append(t)
        nbytes, ops, kinds = cs.deblock_work(*args)
        cs.log(json.dumps({"deblock": {
            "input": what, "planes": [tuple(p.shape) for p in args[0]],
            "runs": runs, "edges": kinds,
            **cs.bound_terms(int_rate, nbytes, ops), "card": card}}))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
