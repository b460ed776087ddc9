"""Shared helpers of the tests/test_torch_*.py files: the committed
streams of av1dec_tpu_torch/testdata and their parse by either package."""
import json
import os

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "av1dec_tpu_torch", "testdata")
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


def decode_capture(name):
    """Decode a committed stream with the port's Decoder on the CPU.
    Returns (display MD5s, Decoder.stats, the DeviceRecon of every coded
    frame, in coding order)."""
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
