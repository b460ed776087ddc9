"""The all-intra slice of av1dec_tpu_torch end to end, on the CPU:

- DeviceRecon.run() and decode_stream_batched == the JAX package's
  DeviceRecon.run() on two streams (8-bit 4:2:0 with deblock + CDEF,
  and 10-bit), and those equal the committed manifest;
- the port's Decoder reproduces the manifest's per-frame MD5s on every
  committed small stream of the device path, intra and inter (those of
  the host pixel path: tests/test_torch_recon.py), and so does the
  libaom oracle on every committed small stream;
- inter frames with a tool the device path cannot take (OBMC, warped
  motion) decode on the host pixel path, equal to libaom, the device
  path naming the tool; compound frames (average, distance-weighted,
  difference-weighted) decode equal to libaom on the paths the manifest
  records; a simple inter frame decodes on the device path; the batched
  all-intra decode refuses inter frames and decodes an intra block copy
  key frame inline on the host pixel path.
"""
import numpy as np
import pytest

from torch_port_helpers import (manifest, parse, small_streams,
                                stream_path, tus)


def _display(planes, hdr, seq):
    from av1dec_tpu_torch.api import display_md5
    return display_md5(planes, seq["bit_depth"], hdr["upscaled_width"],
                       hdr["frame_height"],
                       (seq["subsampling_x"], seq["subsampling_y"]))


@pytest.mark.parametrize("name", ["tiles", "bd10"])
def test_slice_matches_jax_device_recon(name, native_lib):
    from av1dec_tpu.pipeline.device_recon import DeviceRecon as JDR
    from av1dec_tpu_torch.api import decode_stream_batched
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon as TDR
    want = manifest()[name]["frames"]
    jframes, tframes = parse(name, "jax"), parse(name, "torch")
    batched = decode_stream_batched(tus(name), device="cpu", batch=2)
    assert len(batched) == len(jframes) == len(want)
    for (js, jh, jp), (ts, th, tp), b, md5 in zip(jframes, tframes,
                                                  batched, want):
        ref = JDR(js, jh, jp).run()
        got = TDR(ts, th, tp).run("cpu")
        assert len(got) == len(b) == len(ref)
        for g, bb, r in zip(got, b, ref):
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(bb, r)
        assert _display(ref, jh, js) == md5


def test_decoder_matches_manifest_on_every_small_stream(native_lib):
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    man = manifest()
    # the streams of the host pixel path: tests/test_torch_recon.py
    names = [n for n in small_streams() if not man[n].get("host")]
    assert len(names) >= 16
    for name in names:
        dec = Decoder(DecoderConfig(), device="cpu")
        got = []
        for tu in tus(name):
            got += [f.display_md5() for f in dec.decode(tu)]
        assert all(s["recon_path"] == "device" for s in dec.stats)
        dec.close()
        assert got == man[name]["frames"], name


@pytest.mark.parametrize("name", small_streams())
def test_manifest_matches_libaom(name):
    import aomffi
    want = manifest()[name]["frames"]
    seq = parse(name, "torch")[0][0]
    n_planes = 1 if seq["mono_chrome"] else 3
    frames = aomffi.oracle_decode_ivf(stream_path(name))
    got = [_display([f.y, f.u, f.v][:n_planes],
                    {"upscaled_width": f.y.shape[1],
                     "frame_height": f.y.shape[0]}, seq) for f in frames]
    assert got == want


def _decode_case(case, tmp_path):
    """The gen_inter_battery stream `case`: (its path, a Decoder, the
    frames it showed, the error that stopped it or None)."""
    import gen_inter_battery as gb
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.container import read_ivf
    path = gb.gen_case(case, gb.CASES[case], str(tmp_path))
    dec = Decoder(device="cpu")
    shown, err = [], None
    try:
        for _, tu in read_ivf(path):
            shown += dec.decode(tu)
    except NotImplementedError as e:
        err = e
    dec.close()
    return path, dec, shown, err


def _decodes_on_host(case, tool, tmp_path):
    """Every frame of the stream `case` decodes equal to libaom; the
    frames with `tool` take the host pixel path, the device path naming
    the tool."""
    import aomffi
    path, dec, shown, err = _decode_case(case, tmp_path)
    assert err is None
    host = [s for s in dec.stats if s["recon_path"] == "host"]
    assert host and any(tool in s["host_reason"] for s in host)
    assert dec.stats[0]["intra"] and dec.stats[0]["recon_path"] == "device"
    ora = aomffi.oracle_decode_ivf(path)
    assert len(shown) == len(ora)
    for f, o in zip(shown, ora):
        for p, r in zip(f.planes, (o.y, o.u, o.v)):
            np.testing.assert_array_equal(
                np.asarray(p)[:r.shape[0], :r.shape[1]], r)


def test_inter_frame_raises_not_implemented(tmp_path):
    """OBMC frames: once refused, now on the host pixel path."""
    _decodes_on_host("obmconly", "OBMC", tmp_path)


def test_warped_inter_frame_raises_not_implemented(tmp_path):
    """Local warped motion frames: once refused, now on the host pixel
    path."""
    _decodes_on_host("warponly", "local warped motion", tmp_path)


@pytest.mark.parametrize("case", ["c4", "c5", "masked"])
def test_compound_inter_frame_raises_not_implemented(case, native_lib):
    """Compound frames decode (they were refused while the reference's
    compound prediction differed from libaom): distance-weighted (c4)
    and average (c5) compound on the device path, difference-weighted
    (masked) on the host pixel path, every frame equal to libaom's MD5
    on the recon path the manifest records, none refused.  (The name
    is kept from the refusal test this replaced, so that test records
    before and after it compare.)"""
    from av1dec_tpu_torch.api import Decoder
    want = manifest()[case]
    dec = Decoder(device="cpu")
    got = []
    for tu in tus(case):
        got += [f.display_md5() for f in dec.decode(tu)]
    dec.close()
    assert got == want["frames"]
    paths = [s["recon_path"] for s in dec.stats]
    assert paths == want["paths"]
    assert ("host" in paths) == (case == "masked")
    for s in dec.stats:
        assert s["host_reason"] is None or \
            "difference-weighted" in s["host_reason"]


def test_simple_inter_frame_decodes(tmp_path):
    """A random-noise key frame and inter frame: both decode on the
    device path and equal the libaom oracle."""
    import aomffi
    from av1dec_tpu_torch.api import Decoder
    rng = np.random.default_rng(0)
    enc = aomffi.AomEncoder(64, 64, cpu_used=8, kf_max_dist=9999, lag=0)
    pkts = []
    for i in range(2):
        y = rng.integers(0, 256, (64, 64)).astype(np.uint8)
        c = np.full((32, 32), 128, np.uint8)
        pkts += enc.encode(y, c, c, pts=i)
    pkts += enc.flush()
    enc.close()
    path = str(tmp_path / "noise.ivf")
    aomffi.write_ivf(path, pkts, 64, 64)
    dec = Decoder(device="cpu")
    got = []
    for _, tu in pkts:
        got += dec.decode(tu)
    dec.close()
    assert [s["intra"] for s in dec.stats] == [1, 0]
    assert all(s["recon_path"] == "device" for s in dec.stats)
    ora = aomffi.oracle_decode_ivf(path)
    assert len(got) == len(ora) == 2
    for f, o in zip(got, ora):
        for p, r in zip(f.planes, (o.y, o.u, o.v)):
            np.testing.assert_array_equal(np.asarray(p)[:64, :r.shape[1]],
                                          r)


def test_batched_decode_raises_on_inter_frame(native_lib):
    from av1dec_tpu_torch.api import decode_stream_batched
    with pytest.raises(NotImplementedError, match="all-intra"):
        decode_stream_batched(tus("t160x96"), device="cpu")


def test_batched_decode_takes_host_intra_frame(native_lib):
    """`screen`'s TU 0 is an intra block copy key frame, which the
    device path refuses: the batched decode takes it inline on the host
    pixel path, equal to the manifest."""
    from av1dec_tpu_torch.api import decode_stream_batched
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    want = manifest()["screen"]
    assert want["paths"][0] == "host"
    (seq, hdr, plans), = parse("screen", "torch")[:1]
    assert not DeviceRecon(seq, hdr, plans).supported()
    tm = {}
    out = decode_stream_batched(tus("screen")[:1], device="cpu", batch=4,
                                timings=tm)
    assert len(out) == 1 and tm["host_path"] > 0
    assert _display(out[0], hdr, seq) == want["frames"][0]
