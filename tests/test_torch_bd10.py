"""10-bit inter decode of av1dec_tpu_torch on the CPU, and the files of
the benchmark's 3840x2160 10-bit configuration:

- `Decoder(device="cpu")` decodes the committed 10-bit inter streams
  (`ra_bd10`: random access with alt-ref frames and distance-weighted
  compound; `inter_bd10`: low delay) equal to the manifest (libaom),
  every frame on the device path, `ra_bd10` with distance-weighted
  compound lanes at 10 bits;
- `fetch.widen` times every device-path frame, and `refs_bytes` counts
  the bytes of the reference tensor `pack_ref_flat` hands MC (1 a
  sample at 8 bits, 4 above);
- `portbench/configs/inter_2160p10.json` is the picture format of each
  stream of its traffic, each stream is the one its record was made
  from, and the record expects every frame on the device path;
- the readers `fetch_widen_ms` and `mc_ref_mib` read these, and nothing,
  without raising, from records that lack them.
"""
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest

from torch_port_helpers import decode_capture, manifest, tus

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(_ROOT, "portbench")
CONFIG = "inter_2160p10"
TRAFFIC = "device_2160p10"
CHROMA = {"4:2:0": [1, 1], "4:2:2": [1, 0], "4:4:4": [0, 0]}


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def _streams():
    return _load("traffic", TRAFFIC + ".json")["streams"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", os.path.join(BENCH, "metrics",
                                                 name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", ["ra_bd10", "inter_bd10"])
def test_10bit_stream_decodes_to_libaom_on_the_device_path(name,
                                                           native_lib):
    from av1dec_tpu_torch.ops.kernels.mc import _MF
    md5s, stats, drs = decode_capture(name)
    assert md5s == manifest()[name]["frames"]
    assert all(s["recon_path"] == "device" for s in stats)
    assert {dr.sch.bd for dr in drs} == {10}
    assert any(not s["intra"] for s in stats)
    dist = 0
    for dr in drs:
        ip = dr._inter_plan
        if ip is None:
            continue
        for (_, comp), rows in ip.lanes.items():
            if comp:
                dist += int((rows[:, _MF["w0"]] != 1).sum())
    # distance-weighted compound lanes (weights other than 1) in the
    # random-access stream, none in the low-delay one
    assert (dist > 0) == (name == "ra_bd10")


@pytest.mark.parametrize("name", ["ra_bd10", "inter_bd10"])
def test_fetch_widen_in_every_device_frame(name, native_lib):
    _, stats, _ = decode_capture(name)
    for s in stats:
        assert s["recon_path"] == "device"
        spans = s["spans_ms"]
        assert "fetch.widen" in spans and spans["fetch.widen"] >= 0
        assert {"fetch", "fetch.copy", "fetch.tail"} <= set(spans)


@pytest.mark.parametrize("name,bd,dtype", [("lowdelay", 8, "uint8"),
                                           ("inter_bd10", 10, "int32")])
def test_refs_bytes_is_the_packed_tensors_nbytes(name, bd, dtype,
                                                 native_lib, monkeypatch):
    """Each inter frame's `refs_bytes` is the `nbytes` of the tensor
    `pack_ref_flat` returned for it: a sample a byte at 8 bits, four
    above; frames without an MC pass count 0."""
    import torch
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.pipeline import device_inter
    real = device_inter.pack_ref_flat
    packed = []

    def keep(pieces, device):
        t = real(pieces, device)
        packed.append((t.dtype, t.nbytes,
                       sum(int(np.prod(np.shape(p))) for p in pieces)))
        return t
    monkeypatch.setattr(device_inter, "pack_ref_flat", keep)
    dec = api.Decoder(device="cpu")
    for tu in tus(name):
        dec.decode(tu)
    dec.close()
    stats = dec.stats
    assert packed and {s["recon_path"] for s in stats} == {"device"}
    got = [s["refs_bytes"] for s in stats if s["refs_bytes"]]
    assert got == [n for _, n, _ in packed]
    width = 1 if bd == 8 else 4
    for dt, n, samples in packed:
        assert dt == getattr(torch, dtype) and n == width * samples
    assert all(s["refs_bytes"] == 0 for s in stats if s["intra"])


def test_2160p10_configuration_matches_its_streams():
    config = _load("configs", CONFIG + ".json")
    fmt = config["format"]
    assert (fmt["width"], fmt["height"], fmt["bit_depth"]) == \
        (3840, 2160, 10)
    streams = _streams()
    assert len(streams) == 2
    for s in streams:
        ref = _load("reference", s + ".json")
        assert (ref["width"], ref["height"], ref["bit_depth"],
                ref["subsampling"], ref["mono"]) == \
            (fmt["width"], fmt["height"], fmt["bit_depth"],
             CHROMA[fmt["chroma"]], False), s
        assert len(ref["frames"]) == ref["made"]["frames"]


@pytest.mark.parametrize("stream", ["bench_2160p10_ra", "bench_2160p10_ld"])
def test_2160p10_stream_is_its_records(stream):
    ref = _load("reference", stream + ".json")
    with open(os.path.join(BENCH, "streams", stream + ".ivf"), "rb") as f:
        data = f.read()
    assert len(data) == ref["bytes"] < 12 * 2 ** 20
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    # every coded frame on the device path
    assert ref["paths"] and set(ref["paths"]) == {"device"}
    assert ref["made"]["bit_depth"] == 10


def test_new_readers_read_the_program_and_nothing_without_it():
    class Record:
        stats = [
            {"intra": 1, "recon_path": "device", "refs_bytes": 0,
             "spans_ms": {"fetch.widen": 9.0}},
            {"intra": 0, "recon_path": "device", "refs_bytes": 2 ** 21,
             "spans_ms": {"fetch.widen": 2.0, "fetch.copy": 1.0}},
            {"intra": 0, "recon_path": "device", "refs_bytes": 2 ** 20,
             "spans_ms": {"fetch.widen": 4.0}},
            {"intra": 0, "recon_path": "host", "refs_bytes": 2 ** 30,
             "spans_ms": {"host.walk": 5.0}},
        ]

    class Run:
        record = Record()
    assert _reader("fetch_widen_ms")(Run()) == 3.0
    assert _reader("mc_ref_mib")(Run()) == 1.5

    class Parent:
        """A program without the span and the counter."""
        stats = [{"intra": 0, "recon_path": "device", "ms": 1.0,
                  "spans_ms": {"fetch.copy": 1.0}},
                 {"intra": 0, "recon_path": "device", "ms": 1.0}]

    class ParentRun:
        record = Parent()
    assert _reader("fetch_widen_ms")(ParentRun()) is None
    assert _reader("mc_ref_mib")(ParentRun()) is None
