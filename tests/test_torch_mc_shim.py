"""The MC kernel `csrc/mc.cu` (one launch for every lane of a frame's MC
pass), compiled with g++ against the CPU shim `tests/cuda_cpu_shim.h`
and run on the host: the exact source, its blocks one after another and
its threads as threads.

- On seeded lanes of every tile size T from 4 to 128, single-list,
  average and distance-weighted compound, motion vectors past every edge
  of the reference and partial w x h windows, at 8 bits (uint8 and
  int32 references), 10 and 12 bits, the kernel's frame is byte-equal
  to the plain pass `_mc_plain`'s; the frame starts random, so a lane
  that writes outside its window shows, and the trash slot is never
  written.
- On the real lanes of every inter frame on the device path of
  `lowdelay`, `interbd10`, `c4`, `c5` (compound) and `masked`, the
  same.
- The source's constants (lane fields, parameters, bucket and tile
  limits) are the Python side's.

Skips when g++ is missing (decided inside the tests).
"""
import re

import numpy as np
import pytest
import torch

from av1dec_tpu_torch.ops.kernels import mc
from torch_port_helpers import (_ROOT, decode_capture, seeded_mc_lanes,
                                shim_build, shim_run)

_CU = f"{_ROOT}/av1dec_tpu_torch/csrc/mc.cu"
TRASH = -7  # the trash slot's value before the pass


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    exe = shim_build(tmp_path_factory.mktemp("mc_shim"), "mc", "mc_frame")
    if exe is None:
        pytest.skip("needs g++ to build the CPU shim")
    return exe


def _check(exe, d, frame0, ref_flat, lanes, cfg):
    """The shim's pass == `_mc_plain`'s on a [frame0, trash] buffer; the
    trash slot untouched.  Returns the pixels the pass changed."""
    frame = torch.as_tensor(np.append(frame0, TRASH).astype(np.int32))
    plain = frame.clone()
    mc._mc_plain(plain, ref_flat, lanes, cfg)
    buckets = tuple(b for b in cfg[0] if b[2] > 0)
    rc, got, err = shim_run(exe, d, mc._params(frame, ref_flat, lanes,
                                               (buckets, cfg[1])),
                            len(buckets), {0})
    assert rc == 0, err
    got = np.frombuffer(got[0], np.int32)
    np.testing.assert_array_equal(got[:-1], plain.numpy()[:-1])
    assert got[-1] == TRASH
    return int((got[:-1] != frame0).sum())


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
    fns, argtypes = cuda_build.KERNELS["mc"]
    assert fns == ("mc_frame",)
    sig = re.search(r'extern "C" int mc_frame\((.*?)\)', src,
                    re.S).group(1)
    assert len(sig.split(",")) == len(argtypes) == 3
