"""The MC kernel `csrc/mc.cu` (one launch for every lane of a frame's MC
pass), compiled with g++ against the CPU shim `tests/cuda_cpu_shim.h`
and run on the host: the exact source, its blocks one after another
(one block, unless a test names more resident) and its threads as
fibers of one OS thread.

- On seeded lanes of every tile size T from 4 to 128, single-list,
  average and distance-weighted compound, motion vectors past every edge
  of the reference and partial w x h windows, at 8 bits (uint8 and
  int32 references), 10 and 12 bits, the kernel's frame is byte-equal
  to the plain pass `_mc_plain`'s; the frame starts random, so a lane
  that writes outside its window shows, and the trash slot is never
  written.  The same on seeded lanes in reference pieces larger than
  any window, where most window rows need no clamp (the kernel copies
  those with cp.async, 8-bit rows as the 16-byte chunks around them, at
  every offset in a chunk), beside rows past the edges.
- The persistent grid takes each stage (an item's list) once, with more
  items than warps, in 1, 2 and 3 blocks: every lane pixel is written
  and no other, and the warp barriers the shim counts are the kernel's
  two a stage for exactly the pass's stages.
- On the real lanes of every inter frame on the device path of
  `lowdelay`, `interbd10`, `c4`, `c5` (compound) and `masked`, the
  same.
- The source's constants (lane fields, parameters, bucket and tile
  limits, the __constant__ filter table) are the Python side's.

Skips when g++ is missing (decided inside the tests).
"""
import re

import numpy as np
import pytest
import torch

from av1dec_tpu_torch.ops.kernels import mc
from torch_port_helpers import (_ROOT, LARGE_PIECES, decode_capture,
                                mc_lane_pixels, seeded_mc_lanes, shim_build,
                                shim_run)

_CU = f"{_ROOT}/av1dec_tpu_torch/csrc/mc.cu"
TRASH = -7  # the trash slot's value before the pass


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    exe = shim_build(tmp_path_factory.mktemp("mc_shim"), "mc", "mc_frame")
    if exe is None:
        pytest.skip("needs g++ to build the CPU shim")
    return exe


def _run(exe, d, frame0, ref_flat, lanes, cfg, resident=0):
    """The shim's pass on a [frame0, trash] buffer, byte-equal to
    `_mc_plain`'s, the trash slot untouched.  Returns (the frame, the
    warp barriers of the launch)."""
    frame = torch.as_tensor(np.append(frame0, TRASH).astype(np.int32))
    plain = frame.clone()
    mc._mc_plain(plain, ref_flat, lanes, cfg)
    buckets = tuple(b for b in cfg[0] if b[2] > 0)
    rc, got, err = shim_run(exe, d, mc._params(frame, ref_flat, lanes,
                                               (buckets, cfg[1])),
                            len(buckets), {0}, resident=resident)
    assert rc == 0, err
    got = np.frombuffer(got[0], np.int32)
    np.testing.assert_array_equal(got[:-1], plain.numpy()[:-1])
    assert got[-1] == TRASH
    return got[:-1], int(re.search(r"(\d+) warp barriers", err).group(1))


def _check(exe, d, frame0, ref_flat, lanes, cfg):
    """`_run`; returns the pixels the pass changed."""
    got, _ = _run(exe, d, frame0, ref_flat, lanes, cfg)
    return int((got != frame0).sum())


@pytest.mark.parametrize("bd,ref", [(8, "uint8"), (8, "int32"),
                                    (10, "int32"), (12, "int32")])
def test_shim_matches_plain_on_seeded_lanes(bd, ref, shim, tmp_path):
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    rng = np.random.default_rng(200 + bd)
    frame0, pieces, lanes = seeded_mc_lanes(bd, rng)
    ref_flat = pack_ref_flat(pieces, "cpu").to(getattr(torch, ref))
    cfg, rows = upload_lanes(lanes, bd, "cpu")
    assert {(T, c) for T, c, _ in cfg[0]} == {
        (T, c) for T in (4, 8, 16, 32, 64, 128) for c in (0, 1)}
    assert _check(shim, tmp_path, frame0, ref_flat, rows, cfg) > 0


@pytest.mark.parametrize("bd,ref", [(8, "uint8"), (8, "int32"),
                                    (10, "int32"), (12, "int32")])
def test_shim_matches_plain_on_seeded_lanes_inside_the_reference(
        bd, ref, shim, tmp_path):
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    rng = np.random.default_rng(400 + bd)
    frame0, pieces, lanes = seeded_mc_lanes(bd, rng, **LARGE_PIECES)
    ref_flat = pack_ref_flat(pieces, "cpu").to(getattr(torch, ref))
    cfg, rows = upload_lanes(lanes, bd, "cpu")
    # windows (of a lane of T <= 32, or of a 32 x 32 tile of a lane) with
    # no column clamp, and windows past an edge, in every bucket
    for (T, comp), r in lanes.items():
        t = min(T, 32)
        for s in "01"[:1 + comp]:
            cx, lx = r[:, mc._MF["cx" + s]], r[:, mc._MF["lx" + s]]
            inside = np.array([(cx + ox >= 0) & (cx + ox + t + 6 <= lx)
                               for ox in range(0, T, t)])
            assert inside.any() and not inside.all(), (T, comp)
    assert _check(shim, tmp_path, frame0, ref_flat, rows, cfg) > 0


def _items(T, n):
    """Items of a bucket: 32 / T lanes of T <= 32, or a 32 x 32 tile of a
    lane of T = 64 or 128."""
    return -(-n // (32 // T)) if T <= 32 else n * (T // 32) ** 2


@pytest.mark.parametrize("resident", [0, -2, -3])
def test_shim_persistent_grid_takes_each_stage_once(resident, shim,
                                                    tmp_path):
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    rng = np.random.default_rng(500)
    frame0, pieces, lanes = seeded_mc_lanes(8, rng)
    cfg, rows = upload_lanes(lanes, 8, "cpu")
    # 8 warps a block; the shim's one SM holds |resident| blocks (0: one),
    # run one after another
    warps = 8 * max(-resident, 1)
    assert sum(_items(T, n) for T, _, n in cfg[0]) > 4 * warps
    frame0[:] = TRASH  # no prediction equals it, so each write shows
    got, barriers = _run(shim, tmp_path, frame0, pack_ref_flat(pieces,
                                                               "cpu"),
                         rows, cfg, resident)
    px = mc_lane_pixels(lanes)
    written = np.flatnonzero(got != TRASH)
    np.testing.assert_array_equal(written, np.sort(px))
    # two a list of each item, in each of the warp's 32 threads
    assert barriers == 32 * 2 * sum(_items(T, n) * (1 + comp)
                                    for T, comp, n in cfg[0])


@pytest.mark.parametrize("name", ["lowdelay", "interbd10", "c4", "c5",
                                  "masked"])
def test_shim_matches_plain_on_stream_lanes(name, shim, tmp_path,
                                            native_lib):
    from av1dec_tpu_torch.pipeline.device_inter import (pack_ref_flat,
                                                        upload_lanes)
    _, _, drs = decode_capture(name)
    rng = np.random.default_rng(7)
    n = 0
    for dr in drs:
        ip = dr._inter_plan
        if ip is None:
            continue
        cfg, rows = upload_lanes(ip.lanes, ip.bd, "cpu")
        frame0 = rng.integers(-5, 1 << ip.bd, dr.sch.flat_len) \
            .astype(np.int32)
        assert _check(shim, tmp_path, frame0, pack_ref_flat(ip.ref_np,
                                                            "cpu"),
                      rows, cfg) > 0
        n += 1
    assert n >= 3


def _enum(src, name):
    body = re.search(r"enum %s : int \{(.*?)\};" % name, src, re.S)
    assert body, name
    return {k: int(v) for k, v in
            re.findall(r"(\w+) = (\d+)", body.group(1))}


def test_mc_constants_locked():
    from av1dec_tpu_torch.ops.kernels import cuda_build
    from av1dec_tpu_torch.pipeline.device_inter import MC_BUCKETS
    with open(_CU) as f:
        src = f.read()
    fields = _enum(src, "Field")
    assert fields.pop("kFields") == len(mc.MC_FIELDS)
    assert fields == {"F_" + n.upper(): i for i, n in enumerate(mc.MC_FIELDS)}
    params = _enum(src, "Param")
    assert params.pop("kParams") == len(mc._PARAMS)
    # the per-bucket parameters are arrays, named by their first entry
    assert params == {"P_" + n.upper(): i for i, n in enumerate(mc._PARAMS)
                      if re.fullmatch(r"[a-z_]+0?", n)}
    assert int(re.search(r"kMaxBuckets = (\d+);", src).group(1)) == \
        mc.MAX_BUCKETS == 2 * len(MC_BUCKETS)
    assert int(re.search(r"kMaxT = (\d+);", src).group(1)) == \
        max(MC_BUCKETS)
    assert mc._FTAB.shape == (6 * 16, 8)
    body = re.search(r"kFtab\[[^]]*\] = \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    assert [int(v) for v in re.findall(r"-?\d+", body)] == \
        mc._FTAB.reshape(-1).tolist()
    fns, argtypes = cuda_build.KERNELS["mc"]
    assert fns == ("mc_frame",)
    sig = re.search(r'extern "C" int mc_frame\((.*?)\)', src,
                    re.S).group(1)
    assert len(sig.split(",")) == len(argtypes) == 3
