"""Time the port's CDEF of one column shard on the card, on every shard of
`bench_1080p_intra`'s frame 0 in 2 and 4 column shards, and optionally
another checkout's shard route on the same inputs.

    python3 tools/time_torch_shard_cdef.py [--other DIR ...] [--iters N]

Frame 0 is decoded with `decode_stream_batched(device="cuda")` (its MD5
is held to the manifest) while the deblocked planes and strengths that
its `cdef_frame` call gets are kept.  Each shard's inputs are the
bordered planes `cdef_local` builds (`_local_pad`) and the shard's
strengths.  A checkout's shard route is its `cdef.cdef_shard` (one
kernel for every plane).  Another checkout's `ops/kernels/cdef.py` and
`cuda_build.py` are loaded under their own names and build its kernels
into its own build directory.  For each version, in the order others,
this, this, others reversed, and each shard it prints the device ms and
kernels of one call (torch.profiler: every device interval), the ms of
its `cdef_shard` kernel alone, the wrapper-inclusive ms (CUDA events) and
the pixels that differ from this tree's output; then each shard's bound
(both terms, from `chip_smoke.shard_work`), the card's name and power
limit, and a JSON line with all of it.
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

SHARDS = (2, 4)
KERNEL = "cdef_shard_kernel"
_KERNELS = "av1dec_tpu_torch.ops.kernels"


class Version:
    """The shard route of the checkout at `root` (None: this tree)."""

    def __init__(self, root, tag):
        from av1dec_tpu_torch.ops.kernels import cdef, cuda_build
        self.tag = tag
        if root is None:
            self.cdef, self.build = cdef, cuda_build
        else:
            self.cdef = other_checkout.load(root, _KERNELS + ".cdef", tag)
            self.build = other_checkout.load(root, other_checkout.BUILD_MOD,
                                              tag)
            if not hasattr(self.cdef, "cdef_shard"):
                raise SystemExit(f"{root} has no cdef.cdef_shard")
        self.build.build_kernels()

    def active(self):
        """This version's `cuda_build` in place of the tree's."""
        return other_checkout.kernels_of(self.build)

    def route(self, pads, strengths, bd, damping, subx, suby):
        """A function of no argument that runs the shard route once."""
        return lambda: self.cdef.cdef_shard(pads, *strengths, bd, damping,
                                            subx, suby)


def frame0(dev):
    """Phase 3's frame 0: (planes, gates, bd, damping, subx, suby)."""
    from av1dec_tpu_torch.api import decode_stream_batched, display_md5
    from av1dec_tpu_torch.ops.kernels import cdef
    with open(os.path.join(cs.TESTDATA, "manifest.json")) as f:
        want = json.load(f)[cs.BIG]["frames"][:1]
    seen = []
    real = cdef.cdef_frame

    def keep(*args):
        seen.append(args)
        return real(*args)
    cdef.cdef_frame = keep
    try:
        out = decode_stream_batched(cs.read_tus(cs.BIG)[:1], device=dev,
                                    batch=1)
    finally:
        cdef.cdef_frame = real
    got = [display_md5(p, 8, 1920, 1080, (1, 1)) for p in out]
    if got != want or not seen:
        raise AssertionError(f"{cs.BIG} frame 0: equal to the manifest "
                             f"{got == want}, cdef_frame calls {len(seen)}")
    planes, *gates, bd, damping, subx, suby = seen[0]
    return planes, gates, bd, damping, subx, suby


def time_route(fn, iters):
    """Device ms and kernels of one fn() call, the ms of its
    `cdef_shard` kernel alone, and the wrapper-inclusive ms."""
    ev = cs._device_events(fn, iters, KERNEL)
    own = [e for e in ev if KERNEL in e.name]
    kernels = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
    return {"device_ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3 /
            iters, "kernels": len(kernels) / iters,
            "kernel_ms": sum(e.time_range.elapsed_us() for e in own) / 1e3 /
            iters, "wrapper_ms": cs.cuda_ms(fn, iters)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="a checkout whose shard route is timed beside "
                    "this tree's (may be given more than once)")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_shard_cdef: no CUDA device", file=sys.stderr)
        return 1
    from av1dec_tpu_torch import bindings
    bindings.build_native()
    dev = torch.device("cuda")
    this = Version(None, "this")
    others = [Version(root, f"other{i}") for i, root in enumerate(a.other)]
    planes, gates, bd, damping, subx, suby = frame0(dev)
    int_rate = cs.int32_ops_per_s()
    shards = []
    for n in SHARDS:
        for s in range(n):
            pads, strengths = cs.shard_inputs(planes, gates, n, s)
            shards.append({"n": n, "s": s, "args": (pads, strengths, bd,
                                                     damping, subx, suby),
                           "ref": this.route(pads, strengths, bd, damping,
                                             subx, suby)(),
                           "bound": cs.bound_terms(int_rate, *cs.shard_work(
                               planes, gates, bd, subx, suby, n, s))})
    runs = []
    for v in others + [this, this] + others[::-1]:
        with v.active():
            for sh in shards:
                fn = v.route(*sh["args"])
                t = time_route(fn, a.iters)
                t["differing_px"] = sum(int((o != r).sum()) for o, r in
                                        zip(fn(), sh["ref"]))
                t.update(version=v.tag, n=sh["n"], shard=sh["s"],
                         share_of_bound=sh["bound"]["bound_ms"] /
                         t["kernel_ms"])
                cs.log(json.dumps(t))
                runs.append(t)
    card = cs.card_line()
    cs.log(json.dumps({"shard_cdef": {
        "frame": f"{cs.BIG} frame 0", "others": a.other,
        "bounds": [dict(n=sh["n"], shard=sh["s"], **sh["bound"])
                   for sh in shards],
        "runs": runs, "card": card}}))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
