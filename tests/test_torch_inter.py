"""The inter slice of av1dec_tpu_torch on the CPU, against av1dec_tpu:

- on every committed small inter stream, the port's Decoder equals the
  manifest (libaom) with every frame on the device path, and per frame
  its schedule, `frame_eligible`, InterPlan lanes and reference layout
  equal the JAX package's (from the same references);
- a scan whose windows hold MF_INTER lanes, after the MC pass, equals
  the JAX scan with has_inter set, on the JAX package's own prep;
- the port's Decoder equals the JAX Decoder (device path, CPU backend)
  frame by frame on one small inter stream.
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import (decode_capture, inter_streams, jax_refs,
                                manifest, parse, tus)

_DECODED = {}


def _decoded(name):
    """decode_capture(name), once per stream and process."""
    if name not in _DECODED:
        _DECODED[name] = decode_capture(name)
    return _DECODED[name]


def _schedules_equal(a, b):
    assert sorted(a.classes) == sorted(b.classes)
    for key in a.classes:
        ca, cb = a.classes[key], b.classes[key]
        np.testing.assert_array_equal(ca.levels_sorted, cb.levels_sorted)
        for f in ca.packed:
            np.testing.assert_array_equal(ca.packed[f], cb.packed[f], f)
    for attr in ("n_levels", "has_inter", "res_count", "res_recs",
                 "plane_base", "flat_len"):
        assert getattr(a, attr) == getattr(b, attr), attr


@pytest.mark.parametrize("name", inter_streams())
def test_inter_stream_matches_manifest(name, native_lib):
    md5s, stats, drs = _decoded(name)
    assert md5s == manifest()[name]["frames"]
    assert all(s["recon_path"] == "device" for s in stats)
    for dr in drs:
        assert dr.supported()
        assert (dr._inter_plan is not None) == dr.sch.has_inter


@pytest.mark.parametrize("name", inter_streams())
def test_inter_plan_matches_jax(name, native_lib):
    from av1dec_tpu.pipeline import device_inter as jdi
    from av1dec_tpu.pipeline import wavefront as jwf
    from av1dec_tpu_torch.pipeline import device_inter as tdi
    _, _, drs = _decoded(name)
    jframes = parse(name, "jax")
    assert len(jframes) == len(drs)
    n_dev = [0]
    for (js, jh, jp), dr in zip(jframes, drs):
        assert jh == dr.hdr
        jrefs = jax_refs(dr.refs)
        n = dr.sch.num_planes
        ok = jdi.frame_eligible(jh, jp, jrefs, n)
        assert tdi.frame_eligible(dr.hdr, dr.plans, dr.refs, n) == ok
        # the port's policy: the reference's, less compound frames
        compound = (np.asarray(jp.grid("ref1"))[
            np.asarray(jp.grid("is_inter")) != 0] > 0).any()
        assert (tdi.ineligible_reason(dr.hdr, dr.plans, dr.refs, n)
                is None) == (ok and not compound)
        jsch = jwf.build_schedule(js, jh, jp, None,
                                  allow_inter=jrefs is not None)
        _schedules_equal(dr.sch, jsch)
        if dr._inter_plan is None:
            continue
        jip = jdi.InterPlan(js, jh, jp, jrefs, jsch)
        tip = dr._inter_plan
        assert tip._layout == jip._layout
        assert sorted(tip.lanes) == sorted(jip.lanes)
        for key in jip.lanes:
            np.testing.assert_array_equal(tip.lanes[key], jip.lanes[key])
        assert len(tip.ref_np) == len(jip.ref_np)
        for tp, jpc in zip(tip.ref_np, jip.ref_np):
            np.testing.assert_array_equal(np.asarray(tp), jpc)
        # the device reference cache: a reference the device path kept
        # (no host filter tail) is read from its device planes as they are
        pieces = iter(tip.ref_np)
        for r in sorted({r for r, _ in tip._layout}):
            dev = dr.refs[r]["dev_planes"]
            for pl in range(n):
                p = next(pieces)
                assert p is dev[pl] if dev is not None else \
                    isinstance(p, np.ndarray)
        n_dev[0] += sum(isinstance(p, torch.Tensor) for p in tip.ref_np)
    assert n_dev[0] > 0 or not any(dr._inter_plan for dr in drs)


def test_inter_scan_matches_jax(native_lib):
    """MC pass + a scan with MF_INTER windows, on the JAX prep."""
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels.mc import run_mc
    from av1dec_tpu.ops.kernels.wavefront import run_wavefront
    from av1dec_tpu.pipeline.device_recon import DeviceRecon, prep_batch
    from av1dec_tpu_torch.ops.kernels.wavefront import FLAG_INTER
    from av1dec_tpu_torch.pipeline.device_recon import (scan_batch,
                                                        to_torch_inputs)
    _, _, drs = _decoded("neither")
    checked = 0
    for (js, jh, jp), dr in list(zip(parse("neither", "jax"), drs))[2:4]:
        jdr = DeviceRecon(js, jh, jp, refs=jax_refs(dr.refs))
        assert jdr.supported() and jdr._inter_plan is not None
        jprep = prep_batch([jdr])
        config = jprep["config"] + (True,)
        ip = jdr._inter_plan
        mc_cfg, mc_lanes = ip.mc_config_and_lanes(jnp)
        frame = run_mc(jnp.zeros(jprep["flat"], jnp.int32),
                       ip.ref_flat(jnp), mc_lanes, mc_cfg)
        want = np.asarray(run_wavefront(
            frame, {t: (jnp.asarray(p), s, c)
                    for t, (p, s, c) in jprep["inputs_np"].items()},
            jnp.asarray(jprep["res_np"]),
            {t: jnp.asarray(a) for t, a in jprep["pal_np"].items()},
            config))
        prep = dict(jprep, config=config, mc=[(0, ip.lanes, ip.ref_np)])
        inputs = to_torch_inputs(prep, "cpu")
        assert inputs["windows"][2][..., FLAG_INTER].any()
        got = scan_batch(inputs)
        np.testing.assert_array_equal(got.numpy(), want)
        checked += 1
    assert checked == 2


def test_decoder_matches_jax_decoder(native_lib):
    from av1dec_tpu.api import Decoder as JDecoder
    from av1dec_tpu.config import DecoderConfig as JConfig
    name = "t160x96"
    jdec = JDecoder(JConfig(platform="cpu", apply_grain=False))
    want = []
    for tu in tus(name):
        want += jdec.decode(tu)
    assert all(s["recon_path"] == "device" for s in jdec.stats)
    assert sum(not s["intra"] for s in jdec.stats) == 3
    jdec.close()
    md5s, stats, drs = _decoded(name)
    assert [s["recon_path"] for s in stats] == \
        [s["recon_path"] for s in jdec.stats]
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    dec = Decoder(DecoderConfig(apply_grain=False), device="cpu")
    got = []
    for tu in tus(name):
        got += dec.decode(tu)
    dec.close()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g.planes) == len(w.planes)
        for a, b in zip(g.planes, w.planes):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
