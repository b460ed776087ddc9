"""The host pixel path of av1dec_tpu_torch (`pipeline/recon.FrameRecon`,
with B7 and CDEF on the device, and film grain at output), on the CPU:

- `Decoder(device="cpu")` equals the manifest (libaom, film grain
  applied) on every committed host-path stream, each coded frame on the
  recon path the generator recorded from the reference;
- on two streams (OBMC and warp; screen content with intra block copy
  and palette) every output frame equals the JAX Decoder's, plane by
  plane;
- a device-path inter frame reads a reference that the host path made
  (its host planes: no device copy is kept for a host frame);
- `FrameRecon`'s residuals (device buckets and the NumPy route of
  quantizer-matrix, lossless and WHT buckets) equal the JAX
  `FrameRecon`'s on every frame of three streams;
- `residuals_device` takes every device bucket of a frame in one packed
  call (one upload, one `residuals_packed`, one fetch), and its
  residuals equal the JAX `FrameRecon`'s on every frame of an 8-bit and
  a 10-bit inter stream.
"""
import numpy as np
import pytest

from torch_port_helpers import host_streams, manifest, parse, tus


def _decode(name, keep=None):
    """(output frames, stats) of the port's Decoder on the CPU; `keep`
    collects the DeviceRecon of every coded frame."""
    from av1dec_tpu_torch import api
    real = api.DeviceRecon
    if keep is not None:
        class Keep(real):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                keep.append(self)
        api.DeviceRecon = Keep
    try:
        dec = api.Decoder(device="cpu")
        out = []
        for tu in tus(name):
            out += dec.decode(tu)
        dec.close()
    finally:
        api.DeviceRecon = real
    return out, dec.stats


def test_host_streams_committed():
    names = host_streams()
    assert {"obmc", "warp", "scaledref", "screen", "grain"} <= set(names)
    man = manifest()
    assert sum(p == "host" for n in names for p in man[n]["paths"]) >= 20


@pytest.mark.parametrize("name", host_streams())
def test_decoder_matches_manifest_on_host_stream(name, native_lib):
    want = manifest()[name]
    frames, stats = _decode(name)
    assert [f.display_md5() for f in frames] == want["frames"]
    assert [s["recon_path"] for s in stats] == want["paths"]
    for s in stats:
        assert (s["host_reason"] is None) == (s["recon_path"] == "device")


@pytest.mark.parametrize("name", ["obmc", "screen"])
def test_decoder_matches_jax_decoder(name, native_lib):
    """The JAX Decoder on the CPU backend takes every frame on its NumPy
    host path; the port takes the frames its device path can."""
    from av1dec_tpu.api import Decoder as JDecoder
    jdec = JDecoder()
    want = []
    for tu in tus(name):
        want += jdec.decode(tu)
    jdec.close()
    got, stats = _decode(name)
    assert {"host", "device"} <= {s["recon_path"] for s in stats}
    assert len(got) == len(want) == len(manifest()[name]["frames"])
    for g, w in zip(got, want):
        assert len(g.planes) == len(w.planes)
        for a, b in zip(g.planes, w.planes):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_device_frame_reads_host_reference(native_lib):
    """obmconly alternates paths: frame 4 (device) predicts from frames
    1-3 (host), whose planes the DPB holds on the host only."""
    drs = []
    frames, stats = _decode("obmconly", drs)
    paths = [s["recon_path"] for s in stats]
    assert paths == manifest()["obmconly"]["paths"]
    i = paths.index("device", 1)
    assert paths[i - 1] == "host" and drs[i]._inter_plan is not None
    refs = drs[i].refs
    used = {r for r, _ in drs[i]._inter_plan._layout}
    assert any(refs[r]["dev_planes"] is None for r in used)
    assert [f.display_md5() for f in frames] == \
        manifest()["obmconly"]["frames"]


@pytest.mark.parametrize("name", ["qm_inter", "screen", "lossless"])
def test_frame_recon_residuals_match_jax(name, native_lib):
    from av1dec_tpu.pipeline.recon import FrameRecon as JFR
    from av1dec_tpu_torch.pipeline.recon import FrameRecon as TFR
    n = 0
    for (js, jh, jp), (ts, th, tp) in zip(parse(name, "jax"),
                                          parse(name, "torch")):
        want = JFR(js, jh, jp)._precompute_residuals()
        got = TFR(ts, th, tp, device="cpu")._precompute_residuals()
        assert sorted(got) == sorted(want)
        for i in want:
            np.testing.assert_array_equal(got[i], want[i])
        n += len(want)
    assert n > 0


@pytest.mark.parametrize("name", ["warp", "interbd10"])
def test_residuals_device_packed_matches_jax(name, native_lib, monkeypatch):
    from av1dec_tpu.pipeline.recon import FrameRecon as JFR
    from av1dec_tpu_torch.ops.kernels import itx
    from av1dec_tpu_torch.pipeline.recon import FrameRecon as TFR
    calls = []
    real = itx._residuals_plain

    def spy(buf, spans, words, bd):
        calls.append(len(spans))
        return real(buf, spans, words, bd)
    monkeypatch.setattr(itx, "_residuals_plain", spy)
    frames = 0
    for (js, jh, jp), (ts, th, tp) in zip(parse(name, "jax"),
                                          parse(name, "torch")):
        want = JFR(js, jh, jp)._precompute_residuals()
        got = TFR(ts, th, tp, device="cpu")._precompute_residuals()
        assert sorted(got) == sorted(want)
        for i in want:
            np.testing.assert_array_equal(got[i], want[i])
        frames += 1
    # one packed call a frame, most of them with several buckets
    assert len(calls) == frames and max(calls) > 1
