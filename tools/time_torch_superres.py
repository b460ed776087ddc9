"""Time the port's superres kernel (B4, `ops/kernels/superres.superres_planes`:
on the card `csrc/superres.cu`) on four 1080p inputs, and optionally other
checkouts' `superres_planes` on the same inputs.

    python3 tools/time_torch_superres.py [--other DIR ...] [--iters N]

Inputs (seeded planes by `torch_port_helpers.superres_case`, the tables
by `DeviceRecon._superres_args`' arithmetic):
- `d9`: a 1920x1080 4:2:0 8-bit frame upscaled from 1707 columns
  (denominator 9), its 3 planes: the input of the kernel's first
  measurements (`chip_smoke.py` phase 2);
- `d16`: the same from 960 columns (denominator 16);
- `d9_6planes`: `d9`'s planes and 3 more, as the pre-CDEF planes that
  loop restoration reads, in one call;
- `stream`: frame 0 of `bench_1080p_intra_sres` (denominator 16), its
  planes and tables as `decode_stream_batched(device="cuda")` gives them
  to `superres_planes` (`chip_smoke.first_call`: the frame's MD5 held to
  the manifest).

A checkout's kernel is its `ops/kernels/superres.py` and its
`cuda_build.py`, loaded under their own names with
`tools/other_checkout.py` (the wrapper binds its own checkout's launch
helper) and built into its own build directory (e.g. the parent commit
unpacked with `git archive` into `build/parent`).  For each input, in
the order others, this, this, others reversed, it prints the device ms
of one call (torch.profiler: the intervals of its `superres_kernel`
launches), every device interval's ms, the wrapper-inclusive ms (CUDA
events), the launches a call and the pixels that differ from this
tree's plain version `_superres_plain` (0 expected); then the input's
bound (bytes and operations, `chip_smoke.superres_work`), the device ms
of a plain copy of as many bytes (`copy_ms`), the card's name and power
limit, and a JSON line with all of it.  This tree's
kernel is built with `-Xptxas -v`, whose report is printed.  Needs a
CUDA card; exits non-zero without one.
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

_SUPERRES = "av1dec_tpu_torch.ops.kernels.superres"


def versions(others):
    """{name: (superres module, cuda_build module)}: this tree's, and for
    each of `others` that checkout's ("other", "other2", ...), its
    wrapper bound to its own launch helper; each kernel built."""
    from av1dec_tpu_torch.ops.kernels import cuda_build, superres
    out = {"this": (superres, cuda_build)}
    for i, root in enumerate(others):
        tag = "other" if i == 0 else f"other{i + 1}"
        build = other_checkout.load(root, other_checkout.BUILD_MOD, tag)
        with other_checkout.kernels_of(build):
            out[tag] = (other_checkout.load(root, _SUPERRES, tag), build)
    for name, (_, build) in out.items():
        build.build_kernels(["superres"], verbose=name == "this")
    return out


def seeded(denom, seed, dev, pre=False):
    """A seeded 1080p 4:2:0 8-bit upscale's `superres_planes` arguments;
    with `pre` also 3 pre-CDEF planes (6 in the call)."""
    from torch_port_helpers import superres_case
    rng = np.random.default_rng(seed)
    planes, sargs = superres_case(rng, 1920, 1080, denom, "420", 8)
    if pre:
        planes += [rng.integers(0, 256, p.shape).astype(np.int32)
                   for p in planes]
        sargs = list(sargs) * 2

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return [t(p) for p in planes], [tuple(t(x) for x in a)
                                    for a in sargs], 8


def time_version(mod, args, ref, iters):
    def run():
        return mod.superres_planes(*args)
    before = mod.launches
    outs = run()
    launches = mod.launches - before
    dev_ms, kernels, k_ms = cs.traced(run, "superres_kernel", iters,
                                      one_each=False)
    return {"kernel_ms": k_ms, "device_ms": dev_ms, "kernels": kernels,
            "wrapper_ms": cs.cuda_ms(run, iters), "launches": launches,
            "differing_px": sum(int((o != r).sum())
                                for o, r in zip(outs, ref))}


def copy_ms(nbytes, dev, iters):
    """Device ms of one device-to-device copy that reads and writes
    nbytes / 2 bytes each (torch's `copy_`): what the card takes to move
    as many bytes as the bound counts, as plain traffic."""
    src = torch.zeros(nbytes // 8, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    return cs.traced(lambda: dst.copy_(src), "", iters, one_each=False)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="a checkout whose superres_planes is timed beside "
                    "this tree's (repeatable)")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_superres: no CUDA device", file=sys.stderr)
        return 1
    from av1dec_tpu_torch import bindings
    from av1dec_tpu_torch.ops.kernels import superres
    bindings.build_native()
    vers = versions(a.other)
    others = [k for k in vers if k != "this"]
    order = others + ["this", "this"] + others[::-1] if others else \
        ["this"] * 2
    dev = torch.device("cuda")
    inputs = {"d9": seeded(9, 1, dev), "d16": seeded(16, 2, dev),
              "d9_6planes": seeded(9, 3, dev, pre=True),
              "stream": cs.first_call(cs.BIG_SRES, dev, "superres_planes")}
    card = cs.card_line()
    int_rate = cs.int32_ops_per_s()
    for what, args in inputs.items():
        ref = superres._superres_plain(*args)
        runs = []
        for name in order:
            t = time_version(vers[name][0], args, ref, a.iters)
            t["version"] = name
            cs.log(json.dumps({"input": what, **t}))
            runs.append(t)
        nbytes, ops = cs.superres_work(args[0], args[1], ref)
        cs.log(json.dumps({"superres": {
            "input": what, "planes": [tuple(p.shape) for p in args[0]],
            "widths": [c.shape[0] for c, _ in args[1]], "runs": runs,
            **cs.bound_terms(int_rate, nbytes, ops),
            "copy_ms": copy_ms(nbytes, dev, a.iters), "card": card}}))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
