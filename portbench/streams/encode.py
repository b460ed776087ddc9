"""Encodes the benchmark's long 1080p inter streams with libaom and
writes each beside its reference record (`portbench/reference/`).

    python3 portbench/streams/encode.py NAME [--threads N]

NAME is a key of RECIPES.  The content is the port's inter test content
(`tools/gen_torch_testdata.py:_encode_1080p_inter`: a seeded texture that
moves 3 pixels right and 2 down a frame) with a margin wide enough for
every frame; libaom (`tools/aomffi.py`, the system's `libaom.so.3`)
encodes it and decodes it again, and the record holds libaom's MD5 of
each displayed frame.  The recon path each coded frame is expected to
take (`paths`, "device" or "host") is the port's routing rule
(`device_inter.ineligible_reason`) applied to the port's parse of the
stream, as the port's testdata manifest records its host streams' paths:
it says which layers a cell's frames exercise, and `run.py` counts the
frames that took another path.  It is no part of the comparison that
decides `correct`, which reads libaom's MD5s alone."""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

HOST_TOOLS = [("enable-obmc", "1"), ("enable-warped-motion", "1"),
              ("enable-global-motion", "1"),
              ("enable-interintra-comp", "1"),
              ("enable-masked-comp", "0")]
SIMPLE_TOOLS = [("enable-obmc", "0"), ("enable-warped-motion", "0"),
                ("enable-masked-comp", "0"),
                ("enable-interintra-comp", "0"),
                ("enable-global-motion", "0")]
# frames, cpu-used, tool switches, cq-level, lag-in-frames, seed
RECIPES = {
    # random access: lag 8, alt-ref frames and distance-weighted
    # compound, as the port's testdata bench_1080p_compound, one key
    # frame in 64
    "bench_1080p_ra64": dict(
        frames=64, cpu=1, cq=40, lag=8, seed=17,
        tools=SIMPLE_TOOLS + [("enable-dist-wtd-comp", "1"),
                              ("auto-alt-ref", "1")]),
    # low delay: lag 0, as bench_1080p_inter, one key frame
    "bench_1080p_ld64": dict(frames=64, cpu=6, cq=40, lag=0, seed=17,
                             tools=SIMPLE_TOOLS),
    # libaom's default inter tools, as bench_1080p_host and
    # bench_1080p_host_cq40: most inter frames take the host pixel path
    "bench_1080p_host16": dict(frames=16, cpu=3, cq=44, lag=0, seed=17,
                               tools=HOST_TOOLS),
    "bench_1080p_host16_cq40": dict(frames=16, cpu=3, cq=40, lag=0,
                                    seed=17, tools=HOST_TOOLS),
}
W, H = 1920, 1080


def content(frames, seed):
    """(y, u, v) of each frame: the inter test content, its margin wide
    enough for `frames` frames of motion."""
    rng = np.random.default_rng(seed)
    pad = 64 * ((3 * frames + 63) // 64)
    yy, xx = np.mgrid[:H + pad, :W + pad]
    base_y = (110 + 70 * np.sin(xx / 17.0) * np.cos(yy / 23.0) +
              rng.normal(0, 10, (H + pad, W + pad))).clip(0, 255) \
        .astype(np.uint8)
    base_u = (128 + 40 * np.sin(xx[::2, ::2] / 13.0)).clip(0, 255) \
        .astype(np.uint8)
    base_v = (128 + 40 * np.cos(yy[::2, ::2] / 15.0)).clip(0, 255) \
        .astype(np.uint8)
    for i in range(frames):
        dy, dx = 2 * i, 3 * i
        yield (base_y[dy:dy + H, dx:dx + W],
               base_u[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2],
               base_v[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2])


def routed_paths(path):
    """The recon path of each coded frame of the stream at `path` by the
    port's routing rule, its references all of the frame's size."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(HERE))
    from pbcore.drive import read_ivf
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.pipeline import device_inter
    parser = NativeParser()
    paths = []
    for tu in read_ivf(path):
        for hdr, plans in parser.parse_tu(tu, with_plans=True):
            if hdr.get("show_existing_frame"):
                continue
            if hdr.get("frame_is_intra", 1):
                paths.append("device")
                continue
            size = {"width": hdr["frame_width"],
                    "height": hdr["frame_height"]}
            refs = dict.fromkeys(range(1, 8), size)
            why = device_inter.ineligible_reason(hdr, plans, refs, 3)
            paths.append("device" if why is None else "host")
    parser.close()
    return paths


def encode(name, threads):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import aomffi
    r = RECIPES[name]
    path = os.path.join(HERE, name + ".ivf")
    enc = aomffi.AomEncoder(
        W, H, cpu_used=r["cpu"], kf_max_dist=9999, lag=r["lag"],
        end_usage=3, threads=threads,
        options=[("cq-level", str(r["cq"]))] + r["tools"])
    pkts = []
    for i, (y, u, v) in enumerate(content(r["frames"], r["seed"])):
        pkts += enc.encode(y, u, v, pts=i)
        print(f"{name}: frame {i} in", flush=True)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, W, H)
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
                 **{k: v for k, v in r.items() if k != "tools"},
                 "tools": dict(r["tools"])},
    }
    with open(os.path.join(os.path.dirname(HERE), "reference",
                           name + ".json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(pkts)} temporal units, {len(frames)} frames, "
          f"{len(data)} bytes", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("name", choices=sorted(RECIPES))
    p.add_argument("--threads", type=int, default=2)
    a = p.parse_args(argv)
    encode(a.name, a.threads)


if __name__ == "__main__":
    main()
