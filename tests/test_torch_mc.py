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
  its w x h window shows."""
import numpy as np
import pytest
import torch

from torch_port_helpers import decode_capture, jax_refs, parse

QUANT_DIST_LOOKUP = [(9, 7), (11, 5), (12, 4), (13, 3)]


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


def _seeded_lanes(bd, rng):
    """(frame0, ref pieces, lanes) covering every bucket, both lists,
    both compound kinds, the four clamp corners and all filter banks."""
    from av1dec_tpu_torch.ops.kernels.mc import MC_FIELDS, _MF
    from av1dec_tpu_torch.pipeline.device_inter import MC_BUCKETS
    dt = np.uint8 if bd == 8 else np.uint16
    shapes = [(40, 56), (23, 31)]        # (h, w) of two reference pieces
    pieces = [rng.integers(0, 1 << bd, s).astype(dt) for s in shapes]
    rbs = [0, 40 * 56]
    post = 14 - (5 if bd == 12 else 3) - 7
    lanes, base = {}, 0
    for T in MC_BUCKETS:
        for comp in (0, 1):
            N = 8 if T <= 32 else 4
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


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_run_mc_matches_jax_on_seeded_lanes(bd):
    rng = np.random.default_rng(100 + bd)
    frame0, pieces, lanes = _seeded_lanes(bd, rng)
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
