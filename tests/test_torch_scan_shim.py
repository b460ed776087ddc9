"""The persistent scan kernel `csrc/wavefront_scan.cu`, compiled with g++
against the CPU shim `tests/cuda_cpu_shim.h` and run on the host: the
exact source, its blocks as processes and its threads as threads.

- With 1 resident block (the blocks take every ticket in turn) and with
  3 at once (blocks wait on each other's levels through the counters),
  the kernel's frame is byte-equal to `scan_batch`'s plain scan on the
  committed small streams (8 and 10 bits, 4:2:0, 4:4:4 and mono,
  palette, two frames a batch, MF_INTER lanes), and its counters report
  every level with lanes complete.
- `wavefront_scan_floor` runs the same protocol and writes no pixel.
- A ticket table whose wait can never be met traps after the kernel's
  wait limit instead of hanging.

Skips when g++ is missing (decided inside the tests).
"""
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import parse, shim_build, shim_run

# (stream, frames per batch); lowdelay's batch is its first frame with
# MF_INTER lanes
CASES = [("base", 1), ("palette", 1), ("i444", 1), ("mono", 1),
         ("bd10", 1), ("multi", 2), ("lowdelay", 1)]


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The g++ build of the kernel source with the shim and its main."""
    exe = shim_build(tmp_path_factory.mktemp("shim"), "wavefront_scan")
    if exe is None:
        pytest.skip("needs g++ to build the CPU shim")
    return exe


def _inputs(name, k):
    from av1dec_tpu_torch.pipeline.device_recon import (DeviceRecon,
                                                        prep_batch,
                                                        to_torch_inputs)
    from av1dec_tpu_torch.pipeline.wavefront import MF_INTER
    if name == "lowdelay":
        from torch_port_helpers import decode_capture
        _, _, drs = decode_capture(name)
        drs = [next(dr for dr in drs if dr.supported() and any(
            (bc.packed["mode_family"] == MF_INTER).any()
            for bc in dr.sch.classes.values()))]
    else:
        drs = [DeviceRecon(s, h, p) for s, h, p in parse(name, "torch")[:k]]
    assert len(drs) == k and all(dr.supported() for dr in drs)
    return to_torch_inputs(prep_batch(drs), "cpu")


def _mc_frame(inputs):
    from av1dec_tpu_torch.pipeline.device_recon import mc_into
    frame = torch.zeros(inputs["n"] + 1, dtype=torch.int32)
    for ref_flat, lanes, cfg in inputs["mc"]:
        mc_into(frame, ref_flat, lanes, cfg)
    return frame


def _run(exe, d, inputs, entry, resident, tickets=None):
    """The shim's run of `entry` on the batch: (return code, frame,
    counters, stderr)."""
    from av1dec_tpu_torch.ops.kernels import wavefront as W
    from av1dec_tpu_torch.pipeline.device_recon import batch_residuals
    table, lanes, tickets_np, _ = inputs["levels"]
    if tickets is None:
        tickets = tickets_np
    live = lanes[lanes > 0]
    frame = _mc_frame(inputs)
    counters = torch.zeros((len(live) + 1) * W.COUNTER_STRIDE,
                           dtype=torch.int32)
    params = W._params(frame, inputs["packed"], batch_residuals(inputs),
                       inputs["pal"], inputs["config"],
                       torch.as_tensor(np.ascontiguousarray(tickets)),
                       counters)
    kf, kc = W._PARAMS.index("frame"), W._PARAMS.index("counters")
    rc, out, err = shim_run(exe, d, params, len(tickets), {kf, kc}, entry,
                            resident)
    if rc != 0:
        return rc, None, None, err
    return (0, np.frombuffer(out[kf], np.int32),
            np.frombuffer(out[kc], np.int32), err)


@pytest.mark.parametrize("resident", [1, 3])
@pytest.mark.parametrize("name,k", CASES, ids=[c[0] for c in CASES])
def test_shim_kernel_matches_plain(name, k, resident, shim, tmp_path,
                                   native_lib):
    from av1dec_tpu_torch.ops.kernels import wavefront as W
    from av1dec_tpu_torch.pipeline.device_recon import scan_batch
    inputs = _inputs(name, k)
    want = scan_batch(inputs).numpy()
    rc, frame, counters, err = _run(shim, tmp_path, inputs, "scan",
                                    resident)
    assert rc == 0, err
    np.testing.assert_array_equal(frame[:-1], want)
    lanes = inputs["levels"][1]
    live = lanes[lanes > 0]
    done = counters.reshape(-1, W.COUNTER_STRIDE)[:, 0]
    # every ticket taken, then one more a block; every level complete
    blocks = min(resident, int(lanes.sum()))
    assert done[0] == lanes.sum() + blocks
    np.testing.assert_array_equal(done[1:], live)


def test_shim_floor_protocol(shim, tmp_path, native_lib):
    """The floor runs every ticket's wait and publish, and no pixel."""
    from av1dec_tpu_torch.ops.kernels import wavefront as W
    inputs = _inputs("multi", 2)
    rc, frame, counters, err = _run(shim, tmp_path, inputs, "floor", 3)
    assert rc == 0, err
    np.testing.assert_array_equal(frame, _mc_frame(inputs).numpy())
    lanes = inputs["levels"][1]
    np.testing.assert_array_equal(
        counters.reshape(-1, W.COUNTER_STRIDE)[1:, 0], lanes[lanes > 0])


def test_shim_wait_limit_traps(shim, tmp_path, native_lib):
    """A wait that can never be met (one more lane than the level before
    has) ends in a trap and a failed launch, not a hang."""
    inputs = _inputs("base", 1)
    tickets = inputs["levels"][2].copy()
    last = tickets[:, 2] == tickets[:, 2].max()
    tickets[last, 3] += 1
    t0 = time.monotonic()
    rc, _, _, err = _run(shim, tmp_path, inputs, "scan", 2, tickets)
    assert rc != 0 and "__trap" in err
    assert time.monotonic() - t0 < 60
