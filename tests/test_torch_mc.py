"""The port's MC pass (ops/kernels/mc.run_mc) == av1dec_tpu's run_mc,
exactly (CPU backend):

- on the lanes and reference pieces the JAX InterPlan builds from the
  inter frames of committed 8- and 10-bit streams (references as the
  port's decoder holds them);
- on seeded lanes with the hard cases: motion vectors past every edge
  of the reference (the last-row and last-column clamps), every filter
  bank and subpel phase, single-list, average and distance-weighted
  compound lanes, bit depths 8, 10 and 12, and every tile size T from 4
  to 128.  The frame buffer starts random, so a lane that writes outside
  its w x h window shows;
- `mc_into` on a CPU buffer takes the plain route `_mc_plain` (no kernel
  launch) and equals the JAX `run_mc` on those lanes; another device is
  refused;
- no two MC lanes of a frame write the same pixel, on every inter frame
  on the device path of every committed small stream that has one (the
  kernel `csrc/mc.cu` runs its blocks in no order);
- on a card (`gpu` marker): the kernel, one launch a pass, is byte-equal
  to `_mc_plain` on the seeded lanes (also in reference pieces larger
  than any window, uint8 and int32 references) and on the stream lanes
  of the card's own decode."""
import numpy as np
import pytest
import torch

from torch_port_helpers import (LARGE_PIECES, decode_capture, jax_refs,
                                manifest, mc_lane_pixels, parse,
                                seeded_mc_lanes, small_streams)

# committed small streams whose coded frames include inter frames on the
# device path with inter blocks (an MC pass); the other inter streams'
# inter frames all take the host pixel path or have no inter block
MC_STREAMS = [n for n in small_streams() if manifest()[n].get("inter") and
              n not in ("bframes", "obmc", "scaledref2", "sres_inter")]


def _jax_mc(frame0, ref_np, lanes_np, bd):
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels.mc import run_mc
    keys = sorted(k for k in lanes_np if len(lanes_np[k]))
    config = (tuple((T, c, len(lanes_np[(T, c)])) for T, c in keys), bd)
    lanes = {k: jnp.asarray(lanes_np[k].astype(np.int32)) for k in keys}
    return np.asarray(run_mc(jnp.asarray(frame0), jnp.asarray(ref_np),
                             lanes, config))


def _port_mc(frame0, pieces, lanes_np, bd):
    from av1dec_tpu_torch.ops.kernels.mc import run_mc
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    cfg, rows = upload_lanes(lanes_np, bd, "cpu")
    out = run_mc(torch.as_tensor(frame0), pack_ref_flat(pieces, "cpu"),
                 rows, cfg)
    assert out.dtype == torch.int32 and out.shape == frame0.shape
    return out.numpy()


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_run_mc_matches_jax_on_seeded_lanes(bd):
    rng = np.random.default_rng(100 + bd)
    frame0, pieces, lanes = seeded_mc_lanes(bd, rng)
    ref_np = np.concatenate([p.reshape(-1) for p in pieces])
    want = _jax_mc(frame0, ref_np, lanes, bd)
    got = _port_mc(frame0, pieces, lanes, bd)
    np.testing.assert_array_equal(got, want)
    assert (got != frame0).any()


@pytest.mark.parametrize("name", ["neither", "inter_bd10"])
def test_run_mc_matches_jax_on_stream_lanes(name, native_lib):
    from av1dec_tpu.pipeline import wavefront as jwf
    from av1dec_tpu.pipeline.device_inter import InterPlan
    _, _, drs = decode_capture(name)
    jframes = parse(name, "jax")
    assert len(jframes) == len(drs)
    n_inter = 0
    for (js, jh, jp), dr in zip(jframes, drs):
        if dr._inter_plan is None:
            continue
        jsch = jwf.build_schedule(js, jh, jp, None, allow_inter=True)
        jip = InterPlan(js, jh, jp, jax_refs(dr.refs), jsch)
        ref_np = np.concatenate([np.asarray(p).reshape(-1)
                                 for p in jip.ref_np])
        frame0 = np.zeros(jsch.flat_len + 64, np.int32)
        want = _jax_mc(frame0, ref_np, jip.lanes, jsch.bd)
        got = _port_mc(frame0, dr._inter_plan.ref_np, jip.lanes, jsch.bd)
        np.testing.assert_array_equal(got, want)
        n_inter += 1
    assert n_inter >= 3


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_mc_into_plain_route_matches_jax(bd):
    from av1dec_tpu_torch.ops.kernels import mc
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    rng = np.random.default_rng(300 + bd)
    frame0, pieces, lanes = seeded_mc_lanes(bd, rng)
    ref_np = np.concatenate([p.reshape(-1) for p in pieces])
    want = _jax_mc(frame0, ref_np, lanes, bd)
    cfg, rows = upload_lanes(lanes, bd, "cpu")
    frame = torch.as_tensor(np.append(frame0, 0).astype(np.int32))
    before = mc.launches
    mc.mc_into(frame, pack_ref_flat(pieces, "cpu"), rows, cfg)
    assert mc.launches == before
    np.testing.assert_array_equal(frame[:-1].numpy(), want)
    with pytest.raises(ValueError, match="unsupported device"):
        mc.mc_into(torch.zeros(8, dtype=torch.int32, device="meta"),
                   pack_ref_flat(pieces, "cpu"), rows, cfg)


@pytest.mark.parametrize("name", MC_STREAMS)
def test_mc_lanes_write_disjoint_pixels(name, native_lib):
    _, _, drs = decode_capture(name)
    n = 0
    for dr in drs:
        if dr._inter_plan is None:
            continue
        px = mc_lane_pixels(dr._inter_plan.lanes)
        assert len(px) and len(np.unique(px)) == len(px), name
        assert px.min() >= 0 and px.max() < dr.sch.flat_len
        n += 1
    assert n > 0


def test_mc_kernel_refuses_what_it_does_not_take():
    """The launch's checks, which run before the kernel is loaded."""
    from av1dec_tpu_torch.ops.kernels import mc
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    frame0, pieces, lanes = seeded_mc_lanes(8, np.random.default_rng(1))
    cfg, rows = upload_lanes(lanes, 8, "cpu")
    frame = torch.zeros(len(frame0) + 1, dtype=torch.int32)
    ref = pack_ref_flat(pieces, "cpu")
    bad_rows = {**rows, (4, 0): rows[(4, 0)][:, :-1]}
    for args, match in (
            ((frame, ref, rows, (cfg[0], 9)), "bits"),
            ((frame.to(torch.int64), ref, rows, cfg), "frame"),
            ((frame, ref.to(torch.int16), rows, cfg), "reference"),
            ((frame, ref, bad_rows, cfg), "bucket"),
            ((frame, ref, rows, (cfg[0] * 2, 8)), "buckets")):
        with pytest.raises(ValueError, match=match):
            mc._mc_kernel(*args)
    # a pass without lanes launches nothing
    before = mc.launches
    mc._mc_kernel(frame, ref, {}, ((), 8))
    assert mc.launches == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run with `pytest -m gpu` on the card)")


def _card_check(frame0, ref_flat, rows, cfg, runs=3):
    """`runs` kernel passes on the card, one launch each, byte-equal to
    `_mc_plain` on the card."""
    from av1dec_tpu_torch.ops.kernels import mc
    frame = torch.as_tensor(np.append(frame0, -7).astype(np.int32),
                            device="cuda")
    plain = frame.clone()
    mc._mc_plain(plain, ref_flat, rows, cfg)
    for _ in range(runs):
        got = frame.clone()
        before = mc.launches
        mc.mc_into(got, ref_flat, rows, cfg)
        assert mc.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got[:-1], plain[:-1]) and int(got[-1]) == -7


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cuda_mc_matches_plain_on_seeded_lanes(bd):
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    _need_card()
    # the default pieces (most window rows clamped), then pieces larger
    # than any window (most rows copied with cp.async, at every offset)
    for seed, kw in ((100, {}), (400, LARGE_PIECES)):
        rng = np.random.default_rng(seed + bd)
        frame0, pieces, lanes = seeded_mc_lanes(bd, rng, **kw)
        ref = pack_ref_flat(pieces, "cuda")
        cfg, rows = upload_lanes(lanes, bd, "cuda")
        _card_check(frame0, ref, rows, cfg)
        _card_check(frame0, ref.to(torch.int32), rows, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["lowdelay", "interbd10", "c4", "c5",
                                  "masked"])
def test_cuda_mc_matches_plain_on_stream_lanes(name):
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    _need_card()
    _, _, drs = decode_capture(name)
    rng = np.random.default_rng(7)
    n = 0
    for dr in drs:
        ip = dr._inter_plan
        if ip is None:
            continue
        cfg, rows = upload_lanes(ip.lanes, ip.bd, "cuda")
        frame0 = rng.integers(0, 1 << ip.bd, dr.sch.flat_len)
        _card_check(frame0, pack_ref_flat(ip.ref_np, "cuda"), rows, cfg)
        n += 1
    assert n >= 3
