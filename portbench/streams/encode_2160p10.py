"""Encodes the benchmark's 3840x2160 10-bit 4:2:0 inter streams with
libaom and writes each beside its reference record
(`portbench/reference/`), in the format `encode.py` writes.

    python3 portbench/streams/encode_2160p10.py NAME [--threads N]

NAME is a key of RECIPES.  The content is `encode.py`'s moving texture
(3 pixels right and 2 down a frame) computed natively in 10 bits: the
texture's values are taken from the same formula at four times the
scale and rounded once, so the two low bits carry data and are not a
scaled 8-bit picture.  libaom (`tools/aomffi.py`, the system's
`libaom.so.3`) encodes it and decodes it again; the record holds
libaom's MD5 of each displayed frame (uint16 little-endian samples) and
the recon path the port's routing rule gives each coded frame
(`encode.routed_paths`)."""
import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, HERE)

from encode import SIMPLE_TOOLS, routed_paths  # noqa: E402

W, H, BIT_DEPTH = 3840, 2160, 10
# frames, cpu-used, tool switches, cq-level, lag-in-frames, seed; both
# with SIMPLE_TOOLS, so that every frame takes the device path
RECIPES = {
    # random access: lag 8, alt-ref frames and distance-weighted compound
    "bench_2160p10_ra": dict(
        frames=48, cpu=1, cq=40, lag=8, seed=17,
        tools=SIMPLE_TOOLS + [("enable-dist-wtd-comp", "1"),
                              ("auto-alt-ref", "1")]),
    # low delay: lag 0, single-reference translational
    "bench_2160p10_ld": dict(frames=48, cpu=6, cq=40, lag=0, seed=17,
                             tools=SIMPLE_TOOLS),
}


def content(frames, seed):
    """(y, u, v) of each frame as uint16 in [0, 1023]: `encode.content`'s
    texture at 10 bits (4 times its 8-bit amplitudes, noise and offsets),
    its margin wide enough for `frames` frames of motion."""
    rng = np.random.default_rng(seed)
    top = (1 << BIT_DEPTH) - 1
    pad = 64 * ((3 * frames + 63) // 64)
    yy, xx = np.mgrid[:H + pad, :W + pad]
    base_y = np.rint(440 + 280 * np.sin(xx / 17.0) * np.cos(yy / 23.0) +
                     rng.normal(0, 40, (H + pad, W + pad))) \
        .clip(0, top).astype(np.uint16)
    del yy, xx
    cy, cx = np.mgrid[:(H + pad) // 2, :(W + pad) // 2]
    base_u = np.rint(512 + 160 * np.sin(cx / 6.5)).clip(0, top) \
        .astype(np.uint16)
    base_v = np.rint(512 + 160 * np.cos(cy / 7.5)).clip(0, top) \
        .astype(np.uint16)
    del cy, cx
    for i in range(frames):
        dy, dx = 2 * i, 3 * i
        yield (base_y[dy:dy + H, dx:dx + W],
               base_u[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2],
               base_v[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2])


def encode(name, threads):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import aomffi
    r = RECIPES[name]
    path = os.path.join(HERE, name + ".ivf")
    t0 = time.monotonic()
    enc = aomffi.AomEncoder(
        W, H, bit_depth=BIT_DEPTH, cpu_used=r["cpu"], kf_max_dist=9999,
        lag=r["lag"], end_usage=3, threads=threads,
        options=[("cq-level", str(r["cq"]))] + r["tools"])
    pkts = []
    for i, (y, u, v) in enumerate(content(r["frames"], r["seed"])):
        pkts += enc.encode(y, u, v, pts=i)
        print(f"{name}: frame {i} in, {time.monotonic() - t0:.0f} s",
              flush=True)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, W, H)
    seconds = time.monotonic() - t0
    frames = aomffi.oracle_decode_ivf(path)
    with open(path, "rb") as f:
        data = f.read()
    f0 = frames[0]
    record = {
        "stream": name + ".ivf", "bytes": len(data),
        "sha256": hashlib.sha256(data).hexdigest(), "tus": len(pkts),
        "width": int(f0.y.shape[1]), "height": int(f0.y.shape[0]),
        "bit_depth": int(f0.bit_depth),
        "subsampling": [int(s) for s in f0.subsampling],
        "mono": f0.u is None,
        "frames": [fr.md5() for fr in frames],
        "paths": routed_paths(path),
        "made": {"encoder": "libaom " + str(aomffi._lib.aom_codec_version()),
                 "bit_depth": BIT_DEPTH,
                 **{k: v for k, v in r.items() if k != "tools"},
                 "tools": dict(r["tools"])},
    }
    with open(os.path.join(os.path.dirname(HERE), "reference",
                           name + ".json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(pkts)} temporal units, {len(frames)} frames, "
          f"{len(data)} bytes, encoded in {seconds:.0f} s", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("name", choices=sorted(RECIPES))
    p.add_argument("--threads", type=int, default=2)
    a = p.parse_args(argv)
    encode(a.name, a.threads)


if __name__ == "__main__":
    main()
