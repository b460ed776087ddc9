"""Shared helpers of the tests/test_torch_*.py files: the committed
streams of av1dec_tpu_torch/testdata and their parse by either package,
seeded MC lanes, and the g++ build and run of a `csrc/` kernel against
the CPU shim `tests/cuda_cpu_shim.h`."""
import json
import os
import shutil
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(_ROOT, "av1dec_tpu_torch", "testdata")
BIG = ("bench_1080p_intra", "bench_1080p_inter", "bench_1080p_host",
       "bench_1080p_host_cq40", "bench_1080p_compound")


def manifest():
    with open(os.path.join(TESTDATA, "manifest.json")) as f:
        return json.load(f)


def small_streams():
    """Names of the committed small streams (all but the 1080p ones)."""
    return sorted(n for n in manifest() if n not in BIG)


def intra_streams():
    """The small all-intra streams."""
    man = manifest()
    return [n for n in small_streams() if not man[n].get("inter")]


def inter_streams():
    """The small streams with inter frames, all on the device path."""
    man = manifest()
    return [n for n in small_streams()
            if man[n].get("inter") and not man[n].get("host")]


def host_streams():
    """The small streams of the host pixel path, or with film grain
    (`"host"` in the manifest, with each coded frame's recon path)."""
    man = manifest()
    return [n for n in small_streams() if man[n].get("host")]


def stream_path(name):
    return os.path.join(TESTDATA, name + ".ivf")


def tus(name):
    from av1dec_tpu_torch.container import read_ivf
    return [d for _, d in read_ivf(stream_path(name))]


def parse(name, pkg):
    """[(seq, hdr, plans)] of every coded frame of a stream, parsed by
    the JAX package's native front end (pkg "jax") or the port's
    ("torch")."""
    if pkg == "jax":
        from av1dec_tpu.bindings import NativeParser
    else:
        from av1dec_tpu_torch.bindings import NativeParser
    p = NativeParser()
    out = []
    for tu in tus(name):
        for hdr, plans in p.parse_tu(tu, with_plans=True):
            if plans is not None:
                out.append((p.seq, hdr, plans))
    p.close()
    return out


_CAPTURED = {}


def decode_capture(name):
    """Decode a committed stream with the port's Decoder on the CPU, once
    a stream and process.  Returns (display MD5s, Decoder.stats, the
    DeviceRecon of every coded frame, in coding order), new lists of the
    memoised decode's objects, which the callers read and do not
    change."""
    if name not in _CAPTURED:
        _CAPTURED[name] = _decode_capture(name)
    return tuple(list(v) for v in _CAPTURED[name])


def _decode_capture(name):
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.config import DecoderConfig
    seen = []

    class Keep(api.DeviceRecon):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    real = api.DeviceRecon
    api.DeviceRecon = Keep
    try:
        dec = api.Decoder(DecoderConfig(apply_grain=False), device="cpu")
        md5s = []
        for tu in tus(name):
            md5s += [f.display_md5() for f in dec.decode(tu)]
        dec.close()
    finally:
        api.DeviceRecon = real
    return md5s, dec.stats, seen


def jax_refs(refs):
    """A DeviceRecon's `refs` for the JAX package: device planes as numpy."""
    if refs is None:
        return None
    return {r: dict(e, dev_planes=None if e["dev_planes"] is None else
                    [p.numpy() for p in e["dev_planes"]])
            for r, e in refs.items()}


# (forward, backward) distance weights of distance-weighted compound
QUANT_DIST_LOOKUP = [(9, 7), (11, 5), (12, 4), (13, 3)]
# seeded_mc_lanes' arguments for reference pieces larger than a window of
# T = 128 (135 x 135), of odd widths, so that rows start at every offset
# of a 16-byte chunk, and 8 lanes a bucket of T > 32
LARGE_PIECES = {"shapes": ((300, 333), (150, 177)), "big_lanes": 8}


def seeded_mc_lanes(bd, rng, shapes=((40, 56), (23, 31)), big_lanes=4):
    """(frame0, ref pieces, lanes) covering every MC bucket, both lists,
    both compound kinds, the four clamp corners and all filter banks;
    the lanes write disjoint pixels of frame0.  `shapes`: the (h, w) of
    the two reference pieces; the default's are smaller than most
    windows, so most rows need a clamp, pieces larger than 128 + 7 put
    most windows inside them.  Buckets of T <= 32 have 8 lanes, the
    others `big_lanes` (4 or more); lanes 0-3 start past the corners."""
    from av1dec_tpu_torch.ops.kernels.mc import MC_FIELDS, _MF
    from av1dec_tpu_torch.pipeline.device_inter import MC_BUCKETS
    dt = np.uint8 if bd == 8 else np.uint16
    pieces = [rng.integers(0, 1 << bd, s).astype(dt) for s in shapes]
    rbs = [0, shapes[0][0] * shapes[0][1]]
    post = 14 - (5 if bd == 12 else 3) - 7
    lanes, base = {}, 0
    for T in MC_BUCKETS:
        for comp in (0, 1):
            N = 8 if T <= 32 else big_lanes
            rows = np.zeros((N, len(MC_FIELDS)), np.int64)
            stride = 4 * T
            for i in range(N):
                r = rows[i]
                r[_MF["x"]], r[_MF["y"]] = (i % 4) * T, (i // 4) * T
                r[_MF["base"]], r[_MF["stride"]] = base, stride
                r[_MF["w"]], r[_MF["h"]] = rng.integers(1, T + 1, 2)
                for s in "01"[:1 + comp]:
                    k = int(rng.integers(2))
                    ph, pw = shapes[k]
                    lx = pw - 1 - int(rng.integers(3))
                    ly = ph - 1 - int(rng.integers(3))
                    # lanes 0-3 start past the four corners, the rest
                    # anywhere from left of the piece to right of it
                    cx, cy = [(-T - 10, -T - 10), (lx + 5, -3),
                              (-3, ly + 5), (lx + 5, ly + 5)][i] \
                        if i < 4 else rng.integers(-T - 12, [lx + 12,
                                                             ly + 12])
                    r[_MF["rb" + s]], r[_MF["rs" + s]] = rbs[k], pw
                    r[_MF["lx" + s]], r[_MF["ly" + s]] = lx, ly
                    r[_MF["cx" + s]], r[_MF["cy" + s]] = cx, cy
                    r[_MF["hf" + s]] = (i * 16 + rng.integers(16)) % 96
                    r[_MF["vf" + s]] = ((i + 3) * 16 +
                                        rng.integers(16)) % 96
                if comp and i % 2:               # distance-weighted
                    fwd, bck = QUANT_DIST_LOOKUP[int(rng.integers(4))]
                    if rng.integers(2):
                        fwd, bck = bck, fwd
                    r[_MF["w0"]], r[_MF["w1"]] = fwd, bck
                    r[_MF["bshift"]] = post + 4
                elif comp:                       # average
                    r[_MF["w0"]] = r[_MF["w1"]] = 1
                    r[_MF["bshift"]] = post + 1
            lanes[(T, comp)] = rows
            base += (N // 4 + 1) * T * stride
    frame0 = rng.integers(-5, 1 << bd, base).astype(np.int32)
    return frame0, pieces, lanes


def mc_lane_pixels(lanes):
    """Flat destination index of every pixel every MC lane writes, from a
    lane dict {(T, comp): [N, F] rows} (host arrays or tensors)."""
    from av1dec_tpu_torch.ops.kernels.mc import _MF
    out = [np.zeros(0, np.int64)]
    for rows in lanes.values():
        rows = rows.cpu().numpy() if hasattr(rows, "cpu") else rows
        for r in np.asarray(rows, np.int64):
            i, j = np.mgrid[:r[_MF["h"]], :r[_MF["w"]]]
            out.append((r[_MF["base"]] + (r[_MF["y"]] + i) * r[_MF["stride"]]
                        + r[_MF["x"]] + j).reshape(-1))
    return np.concatenate(out)


def shim_build(d, source, entry=None):
    """The g++ build of `av1dec_tpu_torch/csrc/<source>.cu` against the
    CPU shim with its main, in directory `d` (a pathlib.Path), calling
    the C function `entry` (default: the scan's entries).  Returns the
    executable, or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    os.makedirs(d / "cuda", exist_ok=True)
    shim = os.path.join(_ROOT, "tests", "cuda_cpu_shim.h")
    for name in ("cuda_runtime.h", "cuda_pipeline.h",
                 os.path.join("cuda", "atomic")):
        (d / name).write_text(f'#include "{shim}"\n')
    cu = os.path.join(_ROOT, "av1dec_tpu_torch", "csrc", source + ".cu")
    (d / "main.cc").write_text(f'#include "{cu}"\n')
    exe = str(d / f"{source}_shim")
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread",
                    "-DCUDA_CPU_SHIM_MAIN"] +
                   ([f"-DCUDA_CPU_SHIM_ENTRY={entry}"] if entry else []) +
                   ["-I", str(d), "-o", exe, str(d / "main.cc")],
                   check=True, capture_output=True, timeout=300)
    return exe


def shim_run(exe, d, params, count, shared, entry="run", resident=0):
    """Run the shim's main on a kernel's parameter list (tensors where it
    takes a pointer, ints) in directory `d`: each tensor goes to a file,
    the tensors at the indices `shared` are read back after the launch.
    `count` is the entry's int argument; `resident` 0 runs the blocks
    one after another.  Returns (return code, {index: bytes}, stderr)."""
    import torch
    lines = []
    for k, v in enumerate(params):
        if torch.is_tensor(v):
            (d / f"p{k}").write_bytes(v.contiguous().cpu().numpy().tobytes())
            lines.append(f"p p{k} {int(k in shared)}")
        else:
            lines.append(f"i {int(v)}")
    (d / "params.txt").write_text("\n".join(lines) + "\n")
    r = subprocess.run([exe, str(d), entry, str(resident), str(count)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        return r.returncode, None, r.stderr
    return 0, {k: (d / f"p{k}.out").read_bytes() for k in shared}, r.stderr
