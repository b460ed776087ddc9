"""Time the port's MC kernel (`csrc/mc.cu`) and residual kernel
(`csrc/itx.cu`) on the card at the main paths' shapes, and optionally
another checkout's kernels on the same inputs.

    python3 tools/time_torch_mc_itx.py [--other DIR ...] [--iters N]

Inputs, each captured from a decode on the card (its MD5s held to the
manifest) or made from a seed:
- `mc inter`: the MC pass of frame 7 of `bench_1080p_inter`, as
  `Decoder(device="cuda")` gives it to `mc_into`;
- `mc compound`: the last MC pass with compound lanes of
  `bench_1080p_compound`;
- `itx host`: the device residual buckets of the last host frame of
  `bench_1080p_host`, packed as `recon.residuals_device` packs them;
- `itx intra`: seeded conformant levels in the blocks of frame 0 of
  `bench_1080p_intra`: its residual blocks' (tx_size, tx_type)
  histogram, counted from its plans and schedule on the host (the
  lossless and quantizer-matrix blocks left out: the kernel does not
  take them), printed beside it.

A checkout's kernels are its `ops/kernels/mc.py` and `itx.py` wrappers
(`mc_into`, `residuals_packed`) and its `cuda_build.py`, loaded under
their own names with `tools/other_checkout.py`, each building its
kernels into its own build directory (e.g. the parent commit unpacked
with `git archive`).  For each version, in the order others, this,
this, others reversed, and each input it prints the device ms of one
call (torch.profiler: every device interval), the ms of its kernel
alone, and the words that differ from this tree's plain version (0
expected); then each input's bound (both terms, `chip_smoke.mc_work` and
`residual_work`), the card's name and power limit, and a JSON line with
all of it (and `-Xptxas -v` of this tree's two kernels when it builds
them).  Needs a CUDA card; exits non-zero without one.
"""
import argparse
import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import other_checkout  # noqa: E402

_KERNELS = "av1dec_tpu_torch.ops.kernels"


class Version:
    """The MC and residual routes of the checkout at `root` (None: this
    tree)."""

    def __init__(self, root, tag):
        from av1dec_tpu_torch.ops.kernels import cuda_build, itx, mc
        self.tag = tag
        if root is None:
            self.mc, self.itx, self.build = mc, itx, cuda_build
        else:
            self.mc = other_checkout.load(root, _KERNELS + ".mc", tag)
            self.itx = other_checkout.load(root, _KERNELS + ".itx", tag)
            self.build = other_checkout.load(root, other_checkout.BUILD_MOD,
                                              tag)
        self.build.build_kernels(["mc", "itx"], verbose=root is None)

    def active(self):
        """This version's `cuda_build` in place of the tree's."""
        return other_checkout.kernels_of(self.build)


def decoded(name, hook_mod, hook, dev):
    """Decode stream `name` with `Decoder(device=dev)` (MD5s held to the
    manifest) while `hook_mod.hook` is wrapped; returns the arguments of
    every call of it."""
    from av1dec_tpu_torch.api import Decoder
    with open(os.path.join(cs.TESTDATA, "manifest.json")) as f:
        want = json.load(f)[name]["frames"]
    seen = []
    real = getattr(hook_mod, hook)

    def keep(*args):
        seen.append(args)
        return real(*args)
    setattr(hook_mod, hook, keep)
    try:
        dec = Decoder(device=dev)
        got = [f.display_md5() for tu in cs.read_tus(name)
               for f in dec.decode(tu)]
        dec.close()
    finally:
        setattr(hook_mod, hook, real)
    if got != want:
        raise SystemExit(f"{name}: frames differ from the manifest")
    return seen


def intra_histogram():
    """{(tx_size, tx_type): blocks} of the residual blocks of frame 0 of
    the all-intra stream that the kernel takes, and the blocks it does
    not (lossless, WHT or a quantizer matrix)."""
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.ops.kernels.itx import valid_transforms
    from av1dec_tpu_torch.pipeline import wavefront as wf
    p = NativeParser()
    (hdr, plans), = [f for f in p.parse_tu(cs.read_tus(cs.BIG)[0],
                                           with_plans=True)
                     if f[1] is not None][:1]
    sch = wf.build_schedule(p.seq, hdr, plans)
    p.close()
    valid = set(valid_transforms())
    q = hdr["quant"]
    hist, other = {}, 0
    lossless = plans.grid("lossless")
    for recs in sch.res_recs.values():
        for i in recs:
            rec = plans.tx[i]
            key = (int(rec[3]), int(rec[4]))
            mi = int(rec[7])
            if key in valid and not q.get("using_qmatrix") and \
                    not lossless[mi // plans.mi_cols, mi % plans.mi_cols]:
                hist[key] = hist.get(key, 0) + 1
            else:
                other += 1
    return hist, other


def intra_buffer(hist, bd=8, seed=11):
    """`itx.pack_buckets` of seeded conformant levels (as phase 2 of
    `chip_smoke.py` makes them) in `hist`'s blocks."""
    from av1dec_tpu_torch.ops.kernels import itx
    from av1dec_tpu_torch.ops.spec import itx as S
    from av1dec_tpu_torch.ops.tables_data import AC_Q, DC_Q
    rng = np.random.default_rng(seed)
    buckets = []
    for (tsz, tt), B in sorted(hist.items()):
        w, h = S.TX_DIMS[tsz]
        m = min(w, 32) * min(h, 32)
        q = rng.integers(0, 256, (2, B))
        dcq = DC_Q[0, q[0]].astype(np.int32)
        acq = AC_Q[0, q[1]].astype(np.int32)
        lim = np.maximum(1, (1 << (bd + 3)) // acq)[:, None]
        levels = np.floor(rng.uniform(-1, 1, (B, m)) * (lim + 1))
        levels[:, 0] = np.floor(rng.uniform(-1, 1, B) *
                                np.maximum(1, (1 << (bd + 6)) // dcq))
        levels[rng.random(levels.shape) < 0.6] = 0
        buckets.append((levels.astype(np.int32), dcq, acq, tsz, tt))
    return itx.pack_buckets(buckets)


def capture(dev):
    """{input name: the arguments of one `mc_into` or `residuals_packed`
    call} (the module docstring's four inputs), and the intra frame's
    histogram."""
    from av1dec_tpu_torch.pipeline import device_recon, recon
    inputs = {}
    passes = decoded(cs.BIG_INTER, device_recon, "mc_into", dev)
    inputs["mc inter"] = passes[-1]
    passes = decoded(cs.BIG_COMPOUND, device_recon, "mc_into", dev)
    inputs["mc compound"] = [p for p in passes
                             if any(c for _, c, _ in p[3][0])][-1]
    buckets, bd, _ = decoded(cs.BIG_HOST, recon, "residuals_device",
                             dev)[-1]
    buf, spans, words = recon.pack_residuals(buckets, bd)
    inputs["itx host"] = (torch.as_tensor(buf, device=dev), spans, words,
                          bd)
    hist, other = intra_histogram()
    buf, spans, words = intra_buffer(hist)
    inputs["itx intra"] = (torch.as_tensor(buf, device=dev), spans, words,
                           8)
    cs.log(json.dumps({"intra_frame0_blocks": sum(hist.values()),
                       "not_taken": other,
                       "histogram": {f"{t},{k}": n for (t, k), n in
                                     sorted(hist.items())}}))
    return inputs, hist


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="root of another checkout to time beside this one")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    from av1dec_tpu_torch.ops.kernels import itx, mc
    inputs, hist = capture(dev)

    # this tree's plain results and each input's bound
    int_rate = cs.int32_ops_per_s()
    want, bounds = {}, {}
    for key, inp in inputs.items():
        if key.startswith("mc"):
            frame, ref_flat, lanes, cfg = inp
            plain = frame.clone()
            mc._mc_plain(plain, ref_flat, lanes, cfg)
            want[key] = plain
            nbytes, ops, n_lanes, px = cs.mc_work(ref_flat, lanes, cfg)
            per = {f"{T},{c}": n for T, c, n in cfg[0]}
            bounds[key] = {"lanes": n_lanes, "pixels": px, "buckets": per,
                           **cs.bound_terms(int_rate, nbytes, ops)}
        else:
            dbuf, spans, words, bd = inp
            want[key] = itx._residuals_plain(dbuf, spans, words, bd)
            nbytes, ops, blocks = cs.residual_work(dbuf.cpu().numpy(),
                                                   spans)
            bounds[key] = {"blocks": blocks, "spans": len(spans),
                           **cs.bound_terms(int_rate, nbytes, ops)}
    torch.cuda.synchronize()

    this = Version(None, "this")
    others = [Version(r, f"other{i}") for i, r in enumerate(args.other)]
    out = []
    for v in others + [this, this] + others[::-1]:
        for key, inp in inputs.items():
            with v.active():
                if key.startswith("mc"):
                    frame, ref_flat, lanes, cfg = inp
                    got = frame.clone()

                    def run():
                        v.mc.mc_into(got, ref_flat, lanes, cfg)
                    name = "mc_kernel"
                    run()
                else:
                    dbuf, spans, words, bd = inp
                    res = {}

                    def run():
                        res["out"] = v.itx.residuals_packed(dbuf, spans,
                                                            words, bd)
                    name = "itx_kernel"
                    run()
                    got = res["out"]
                torch.cuda.synchronize()
                # (the plain MC pass writes its masked pixels to the trash
                # slot, the kernel never)
                n = got.numel() - (key.startswith("mc"))
                diff = int((got[:n] != want[key][:n]).sum())
                d_ms, n_k, k_ms = cs.traced(run, name, args.iters)
            rec = {"version": v.tag, "input": key, "device_ms": d_ms,
                   "kernels": n_k, "kernel_ms": k_ms, "differ": diff,
                   "share_of_bound": bounds[key]["bound_ms"] / k_ms}
            out.append(rec)
            cs.log(json.dumps(rec))
            if diff:
                raise SystemExit(f"{v.tag} {key}: {diff} words differ from "
                                 f"the plain version")
    card = cs.card_line()
    cs.log(json.dumps({"bounds": bounds}))
    cs.log(card)
    cs.log(json.dumps({"time_torch_mc_itx": out, "bounds": bounds,
                       "intra_histogram_blocks": sum(hist.values()),
                       "card": card}))


if __name__ == "__main__":
    main()
