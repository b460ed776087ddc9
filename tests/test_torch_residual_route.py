"""The device path's residuals from the coded levels: `prep_batch` packs
the levels of every block with a residual ("res_levels", in
`itx.pack_blocks`' layout), `to_torch_inputs` uploads them in one copy
and `scan_batch` computes the residuals with one
`recon.residuals_packed` call (`batch_residuals`: the kernel
`csrc/itx.cu` on a card, `_residuals_plain` on the CPU) straight into
the scan's buffer.

- On every committed stream whose frames take the device path (the
  small all-intra and inter streams, 10-bit ones included, and
  `ra_bd10`), each frame's residual buffer equals the reference's NumPy
  route (`_residuals_flat_np`, widened to int32), frame by frame and for
  the all-intra streams' first frames as one batch, and
  `residuals.card` counts its blocks; a lossless frame among them (the
  key frame of `bframes`, at qindex 0) takes the NumPy route.
- Frames with a quantizer matrix or a lossless block (`qm`, `qm_444`,
  `qm_inter`, `lossless`) take the NumPy route ("res_np"):
  `residuals.numpy` counts every block with a residual,
  `residuals.card` none, and the decode still equals libaom's MD5s.
- On a card (`gpu` marker): the kernel's buffer equals the CPU's, one
  launch a batch.
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import (decode_capture, intra_streams,
                                inter_streams, manifest, parse)

from av1dec_tpu_torch import tracing

# the committed streams whose frames take the NumPy route
FALLBACK = ("qm", "qm_444", "qm_inter", "lossless")
ROUTE_STREAMS = [n for n in intra_streams() if n not in FALLBACK] + \
    inter_streams() + ["ra_bd10"]


def _device_frames(name):
    """The DeviceRecon of every coded frame of `name` the device path
    takes: from the port's CPU decode for streams with inter frames (they
    need their references), else from the parse."""
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    if manifest()[name].get("inter"):
        drs = decode_capture(name)[2]
    else:
        drs = [DeviceRecon(s, h, p) for s, h, p in parse(name, "torch")]
    return [dr for dr in drs if dr.supported()]


def _route(drs, device="cpu"):
    """(the batch's prep, its residual buffer on `device`, the unit its
    prep counted into)."""
    from av1dec_tpu_torch.pipeline.device_recon import (batch_residuals,
                                                        prep_batch,
                                                        to_torch_inputs)
    u = tracing.Unit(0, 0)
    with tracing.unit(u):
        prep = prep_batch(drs)
    return prep, batch_residuals(to_torch_inputs(prep, device)), u


def _coded(dr):
    """The frame's blocks with a residual slot."""
    return sum(dr.sch.res_count.values())


def _numpy_route(dr):
    """Whether the frame needs the NumPy route: a quantizer matrix, or a
    lossless block."""
    return bool(dr.hdr["quant"].get("using_qmatrix") or
                dr.plans.grid("lossless").any())


@pytest.mark.parametrize("name", ROUTE_STREAMS)
def test_route_equals_numpy_residuals(name, native_lib):
    drs = _device_frames(name)
    assert drs and not all(map(_numpy_route, drs))
    for dr in drs:
        prep, res, u = _route([dr])
        card = not _numpy_route(dr)
        assert (prep["res_np"] is None) == card == \
            (prep["res_levels"] is not None)
        assert res.shape == (max(1, dr._res_px_tot),)
        if card:
            assert res.dtype == torch.int32
        want = dr._residuals_flat_np().astype(np.int32)
        np.testing.assert_array_equal(res.numpy()[:len(want)], want)
        assert u.counts["residuals.card" if card else "residuals.numpy"] \
            == _coded(dr)
        assert u.counts["residuals.numpy" if card else "residuals.card"] \
            == 0
    # several frames in one batch, each at its stride
    intra = [dr for dr in drs if dr._inter_plan is None and
             not _numpy_route(dr)][:4]
    if len(intra) > 1:
        prep, res, u = _route(intra)
        rf = max(dr._res_px_tot for dr in intra)
        assert res.shape == (len(intra) * rf,)
        for f, dr in enumerate(intra):
            want = dr._residuals_flat_np().astype(np.int32)
            np.testing.assert_array_equal(
                res.numpy()[f * rf:f * rf + len(want)], want)
        assert u.counts["residuals.card"] == sum(map(_coded, intra))


@pytest.mark.parametrize("name", FALLBACK)
def test_fallback_takes_numpy_route(name, native_lib):
    md5s, stats, drs = decode_capture(name)
    assert md5s == manifest()[name]["frames"]
    assert len(stats) == len(drs)
    numpy = 0
    for s, dr in zip(stats, drs):
        blocks = s["residual_blocks"]
        if s["recon_path"] != "device":
            assert blocks == {"card": 0, "numpy": 0}
            continue
        assert blocks == {"card": 0, "numpy": _coded(dr)}
        numpy += blocks["numpy"]
        prep, res, _ = _route([dr])
        assert prep["res_levels"] is None
        np.testing.assert_array_equal(res.numpy(), prep["res_np"])
    assert numpy > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["multi", "lowdelay", "inter_bd10",
                                  "ra_bd10"])
def test_card_route_equals_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run with `pytest -m gpu` on the card)")
    from av1dec_tpu_torch.ops.kernels import itx
    drs = _device_frames(name)
    intra = [dr for dr in drs if dr._inter_plan is None][:4]
    for batch in [[dr] for dr in drs] + ([intra] if len(intra) > 1 else []):
        _, cpu, _ = _route(batch)
        before = itx.launches
        prep, got, _ = _route(batch, "cuda")
        torch.cuda.synchronize()
        rf = max(dr._res_px_tot for dr in batch)
        covered = np.zeros(len(batch) * max(1, rf), bool)
        for f, dr in enumerate(batch):
            covered[f * rf:f * rf + dr._res_px_tot] = True
        assert itx.launches == before + int(
            covered.any() and prep["res_levels"] is not None)
        np.testing.assert_array_equal(got.cpu().numpy()[covered],
                                      cpu.numpy()[covered])
