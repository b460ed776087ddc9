"""The wavefront scan kernel of av1dec_tpu_torch (`csrc/wavefront_scan.cu`,
one persistent launch per batch, its lanes in level-major ticket order)
and what it rests on, on the CPU:

- level-order independence, the precondition of running a level's
  lanes in any order: the plain scan run level by level, each lane a
  window of its own and the lanes and buckets of each level in reverse
  order, gives the same buffer as `scan_batch`
  and as the JAX package's `run_wavefront` on the same prep inputs
  (intra streams through the JAX package's prep, MF_INTER lanes through
  the port's InterPlan and `mc_into`);
- the per-level lane tables cover every lane exactly once, in level
  order, and agree with `make_windows`; the ticket table
  `to_torch_inputs` uploads holds every lane once, level-major, each
  ticket waiting on the previous level with lanes;
- the field, mode-family, ticket, parameter and size constants of the
  CUDA source equal `_DEV_FIELDS`, the `MF_*` codes, `_TICKET`,
  `_PARAMS` and the tables';
- `scan_into` runs the plain version on a CPU buffer and refuses other
  devices;

and, marked `gpu` (skipped without a card), the kernel against the
plain version on the card on every committed small stream, once and 50
times over (the CPU shim of `tests/test_torch_scan_shim.py` runs the
same source on the host).
"""
import os
import re

import numpy as np
import pytest
import torch

from torch_port_helpers import decode_capture, parse, small_streams

_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "av1dec_tpu_torch", "csrc", "wavefront_scan.cu")

# (stream, frames per batch); lowdelay has MF_INTER lanes
ORDER_CASES = [("base", 1), ("palette", 1), ("i444", 1), ("multi", 2),
               ("lowdelay", 1), ("bd10", 1)]


def _jax_prep(name, k):
    from av1dec_tpu.pipeline.device_recon import DeviceRecon, prep_batch
    frames = parse(name, "jax")[:k]
    drs = [DeviceRecon(s, h, p) for s, h, p in frames]
    assert all(dr.supported() for dr in drs)
    return prep_batch(drs)


def _port_inter_prep(name):
    """The port's prep of the first frame of `name` with MF_INTER lanes
    (DeviceRecon with its InterPlan, from the port's CPU decode)."""
    from av1dec_tpu_torch.pipeline.device_recon import prep_batch
    from av1dec_tpu_torch.pipeline.wavefront import MF_INTER
    _, _, drs = decode_capture(name)
    for dr in drs:
        if dr.supported() and any((bc.packed["mode_family"] == MF_INTER)
                                  .any() for bc in dr.sch.classes.values()):
            return prep_batch([dr])
    raise AssertionError(f"{name}: no frame with MF_INTER lanes")


def _mc_frame(inputs):
    """The batch's buffer after the MC pass (zeros for intra batches)."""
    from av1dec_tpu_torch.pipeline.device_recon import mc_into
    frame = torch.zeros(inputs["n"] + 1, dtype=torch.int32,
                        device=inputs["device"])
    for ref_flat, lanes, cfg in inputs["mc"]:
        mc_into(frame, ref_flat, lanes, cfg)
    return frame


def _level_steps(inputs):
    """[L] window steps of each level, as `make_windows` splits them."""
    buckets = inputs["config"][0]
    table = inputs["levels"][0]
    caps = np.asarray([b for _, b in buckets], np.int64)
    return (-(-table[:, :, 1].astype(np.int64) // caps)).max(axis=1)


def _scan_reversed(inputs):
    """The plain scan level by level, each level's lanes one window
    each, in reverse order: buckets last to first, and each bucket's
    lanes last to first."""
    from av1dec_tpu_torch.ops.kernels.wavefront import (_scan_plain,
                                                        window_flags)
    buckets = inputs["config"][0]
    ts = [t for t, _ in buckets]
    table = inputs["levels"][0]
    steps = [(bi, lane) for lvl in range(table.shape[0])
             for bi in reversed(range(len(ts)))
             for lane in reversed(range(table[lvl, bi, 0],
                                        table[lvl, bi, 0] +
                                        table[lvl, bi, 1]))]
    ws = np.zeros((len(steps), len(ts)), np.int32)
    wc = np.zeros_like(ws)
    for k, (bi, lane) in enumerate(steps):
        ws[k, bi], wc[k, bi] = lane, 1
    flags = window_flags({t: inputs["packed"][t].numpy() for t in ts}, ws,
                         wc, ts)
    from av1dec_tpu_torch.pipeline.device_recon import batch_residuals
    frame = _mc_frame(inputs)
    _scan_plain(frame, inputs["packed"], batch_residuals(inputs),
                inputs["pal"],
                inputs["config"], (ws, wc, flags))
    return frame[:-1]


def _jax_scan(prep, frame0, has_inter, res):
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels.wavefront import run_wavefront
    # the JAX scan slices Bmax rows from each window's start: pad the
    # port's exact lane arrays as the JAX prep's capacities do
    bmax = dict(prep["buckets"])
    inputs = {t: (jnp.asarray(np.concatenate(
        [p, np.zeros((bmax[t], p.shape[1]), p.dtype)])), s, c)
        for t, (p, s, c) in prep["inputs_np"].items()}
    config = tuple(prep["config"]) + ((True,) if has_inter else ())
    return np.asarray(run_wavefront(
        jnp.asarray(frame0), inputs, jnp.asarray(res),
        {t: jnp.asarray(a) for t, a in prep["pal_np"].items()}, config))


@pytest.mark.parametrize("name,k", ORDER_CASES,
                         ids=[c[0] for c in ORDER_CASES])
def test_level_order_independence(name, k, native_lib):
    from av1dec_tpu_torch.ops.kernels import wavefront as W
    from av1dec_tpu_torch.pipeline.device_recon import (batch_residuals,
                                                        scan_batch,
                                                        to_torch_inputs)
    inter = name == "lowdelay"
    prep = _port_inter_prep(name) if inter else _jax_prep(name, k)
    assert prep["K"] == k
    inputs = to_torch_inputs(prep, "cpu")
    before = W.launches
    got = scan_batch(inputs)
    assert W.launches == before  # a CPU buffer runs the plain version
    rev = _scan_reversed(inputs)
    assert torch.equal(got, rev)
    frame0 = _mc_frame(inputs)[:-1].numpy()
    if inter:
        assert frame0.any()
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_scan(prep, frame0, inter,
                                            batch_residuals(inputs).numpy()))
    # reversing reorders real work: some level has several lanes
    assert (inputs["levels"][1] > 1).any()


@pytest.mark.parametrize("name,k", [("base", 1), ("multi", 2),
                                    ("lowdelay", 1), ("palette", 1)])
def test_level_tables(name, k, native_lib):
    from av1dec_tpu_torch.ops.kernels.wavefront import make_windows
    from av1dec_tpu_torch.pipeline.device_recon import (prep_batch,
                                                        to_torch_inputs)
    if name == "lowdelay":
        prep = _port_inter_prep(name)
        drs = None
    else:
        from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
        drs = [DeviceRecon(s, h, p) for s, h, p in parse(name, "torch")[:k]]
        prep = prep_batch(drs)
    inputs = to_torch_inputs(prep, "cpu")
    table, lanes, tickets, dev_tickets = inputs["levels"]
    buckets = prep["buckets"]
    ts = [t for t, _ in buckets]
    L = max(len(prep["inputs_np"][t][1]) for t in ts)
    assert table.shape == (L, len(ts), 2) and table.dtype == np.int32
    assert dev_tickets.dtype == torch.int32 and \
        np.array_equal(dev_tickets.numpy(), tickets)
    np.testing.assert_array_equal(lanes, table[:, :, 1].sum(axis=1))
    for bi, t in enumerate(ts):
        n = prep["inputs_np"][t][0].shape[0]
        runs = [np.arange(s, s + c) for s, c in table[:, bi]]
        # every lane exactly once, in level order
        np.testing.assert_array_equal(np.concatenate(runs), np.arange(n))
    if drs is not None:
        # each run holds exactly the lanes the schedule put at its level
        for bi, t in enumerate(ts):
            lv = np.sort(np.concatenate(
                [dr._bucket_rows(t)[1] for dr in drs] + [[]]))
            want = np.bincount(lv.astype(np.int64), minlength=L + 1)[1:]
            np.testing.assert_array_equal(table[:, bi, 1], want)
    # the same runs as the windows of make_windows, level by level
    ws, wc = make_windows({t: table[:, bi, 0] for bi, t in enumerate(ts)},
                          {t: table[:, bi, 1] for bi, t in enumerate(ts)},
                          dict(buckets), ts)
    np.testing.assert_array_equal(ws, inputs["windows"][0])
    np.testing.assert_array_equal(wc, inputs["windows"][1])
    steps = _level_steps(inputs)
    ends = np.cumsum(steps)
    for lvl in range(L):
        sl = slice(ends[lvl] - steps[lvl], ends[lvl])
        for bi in range(len(ts)):
            s, c = table[lvl, bi]
            assert wc[sl, bi].sum() == c
            live = wc[sl, bi] > 0
            if c:
                assert ws[sl, bi][live][0] == s
                np.testing.assert_array_equal(
                    np.diff(ws[sl, bi][live]), wc[sl, bi][live][:-1])


@pytest.mark.parametrize("name,k", ORDER_CASES,
                         ids=[c[0] for c in ORDER_CASES])
def test_ticket_order(name, k, native_lib):
    """Every lane once, level-major (levels with lanes in order, buckets
    in order inside a level, rows in order inside a bucket); each ticket
    names its level's index among the levels with lanes and waits for
    the lanes of the previous one."""
    from av1dec_tpu_torch.ops.kernels.wavefront import _TICKET, plan_levels
    from av1dec_tpu_torch.pipeline.device_recon import (DeviceRecon,
                                                        prep_batch,
                                                        to_torch_inputs)
    if name == "lowdelay":
        prep = _port_inter_prep(name)
    else:
        prep = prep_batch([DeviceRecon(s, h, p)
                           for s, h, p in parse(name, "torch")[:k]])
    table, lanes, tickets, dev_tickets = to_torch_inputs(prep,
                                                         "cpu")["levels"]
    ts = [t for t, _ in prep["buckets"]]
    assert tickets.dtype == np.int32 and \
        tickets.shape == (lanes.sum(), len(_TICKET))
    assert np.array_equal(dev_tickets.numpy(), tickets)
    col = {c: tickets[:, i] for i, c in enumerate(_TICKET)}
    live = np.nonzero(lanes)[0]
    want = [(bi, row, rank)
            for rank, lvl in enumerate(live) for bi in range(len(ts))
            for row in range(table[lvl, bi, 0],
                             table[lvl, bi, 0] + table[lvl, bi, 1])]
    assert [tuple(r) for r in tickets[:, :3].tolist()] == want
    # each lane of each bucket exactly once
    for bi, t in enumerate(ts):
        rows = np.sort(col["row"][col["bucket"] == bi])
        np.testing.assert_array_equal(rows, np.arange(len(rows)))
        assert len(rows) == prep["inputs_np"][t][0].shape[0]
    # the lanes of each level with lanes match plan_levels', and each
    # ticket waits for the lanes of the previous level with lanes
    np.testing.assert_array_equal(np.bincount(col["level"]), lanes[live])
    np.testing.assert_array_equal(
        col["wait"], np.where(col["level"] > 0,
                              lanes[live][col["level"] - 1], 0))
    # the same tables again from the level runs alone
    again = plan_levels({t: table[:, bi, 0] for bi, t in enumerate(ts)},
                        {t: table[:, bi, 1] for bi, t in enumerate(ts)},
                        ts)
    np.testing.assert_array_equal(again[2], tickets)
    assert (lanes[live] > 1).any() and len(live) > 1


def _enum(src, name):
    body = re.search(r"enum %s : int \{(.*?)\};" % name, src, re.S)
    assert body, name
    return {k: int(v) for k, v in
            re.findall(r"(\w+) = (\d+)", body.group(1))}


def test_cuda_constants_locked():
    from av1dec_tpu_torch.ops.kernels import cuda_build
    from av1dec_tpu_torch.ops.kernels import wavefront as W
    from av1dec_tpu_torch.ops.kernels.wavefront import _DEV_FIELDS, _PARAMS
    from av1dec_tpu_torch.pipeline import device_recon
    from av1dec_tpu_torch.pipeline import wavefront as wf
    with open(_CU) as f:
        src = f.read()
    fields = _enum(src, "Field")
    assert fields.pop("kFields") == len(_DEV_FIELDS)
    assert fields == {"F_" + n.upper(): i for i, n in enumerate(_DEV_FIELDS)}
    mfs = {k: v for k, v in vars(wf).items() if k.startswith("MF_")}
    assert _enum(src, "ModeFamily") == mfs and len(mfs) == 11
    params = _enum(src, "Param")
    assert params.pop("kParams") == len(_PARAMS)
    assert params == {"P_" + n.upper(): i for i, n in enumerate(_PARAMS)}
    assert int(re.search(r"kMaxT = (\d+);", src).group(1)) == \
        max(device_recon.BUCKETS)
    assert int(re.search(r"kMaxBuckets = (\d+);", src).group(1)) >= \
        len(device_recon.BUCKETS)
    ticket = _enum(src, "Ticket")
    assert ticket.pop("kTicketFields") == len(W._TICKET)
    assert ticket == {"K_" + n.upper(): i for i, n in enumerate(W._TICKET)}
    sizes = {name: int(re.search(r"%s = ([^;]+);" % name, src).group(1)
                       .replace("*", " ").split()[0]) for name in
             ("kCounterStride", "kSmLen")}
    assert sizes == {"kCounterStride": W.COUNTER_STRIDE,
                     "kSmLen": len(W._SM)}
    assert "kKern = 4 * 5;" in src and W._KERN.shape == (4, 5)
    assert "kFiTaps = 5 * 8 * 7;" in src and W._FI_TAPS.shape == (5, 8, 7)
    # the C signatures the ctypes binding declares
    fns, argtypes = cuda_build.KERNELS["wavefront_scan"]
    assert fns == ("wavefront_scan", "wavefront_scan_floor")
    for fn in fns:
        sig = re.search(r'extern "C" int %s\((.*?)\)' % fn, src,
                        re.S).group(1)
        assert len(sig.split(",")) == len(argtypes) == 3


def test_scan_into_devices(native_lib):
    from av1dec_tpu_torch.ops.kernels import wavefront as W
    from av1dec_tpu_torch.pipeline.device_recon import (batch_residuals,
                                                        prep_batch,
                                                        to_torch_inputs)
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    drs = [DeviceRecon(s, h, p) for s, h, p in parse("base", "torch")]
    inputs = to_torch_inputs(prep_batch(drs), "cpu")
    args = (inputs["packed"], batch_residuals(inputs), inputs["pal"],
            inputs["config"], inputs["windows"], inputs["levels"])
    frame = torch.zeros(inputs["n"] + 1, dtype=torch.int32)
    before = W.launches
    W.scan_into(frame, *args)
    assert W.launches == before and frame[:-1].any()
    plain = torch.zeros_like(frame)
    W._scan_plain(plain, *args[:-1])
    assert torch.equal(frame, plain)
    with pytest.raises(ValueError, match="unsupported device"):
        W.scan_into(torch.zeros(8, dtype=torch.int32, device="meta"),
                    *args)
    # the launch's checks, which run before the kernel is loaded, refuse
    # tickets beyond the lane rows and tables of the wrong shape
    table, lanes, tickets, _ = inputs["levels"]
    bad = tickets.copy()
    bad[-1, 1] = inputs["packed"][inputs["config"][0][bad[-1, 0]][0]] \
        .shape[0]
    for levels, match in (
            ((table, lanes, bad, torch.as_tensor(bad)), "beyond the lane"),
            ((table, lanes, tickets[1:], torch.as_tensor(tickets[1:])),
             "the tickets")):
        with pytest.raises(ValueError, match=match):
            W._launch("wavefront_scan", frame, *args[:4], levels)
    # a batch without lanes launches nothing
    ts = [t for t, _ in inputs["config"][0]]
    zeros = {t: np.zeros(3, np.int32) for t in ts}
    empty = W.plan_levels(zeros, zeros, ts)
    assert empty[2].shape == (0, len(W._TICKET))
    assert W._launch("wavefront_scan", frame, *args[:4], empty +
                     (torch.as_tensor(empty[2]),)) is None


def _card_batches(name):
    """The batches of a small stream the card tests check: every frame
    the device path takes, alone (with its MC pass), and its first up to
    4 intra frames as one batch; each as `to_torch_inputs` gives it on
    the card."""
    from av1dec_tpu_torch.pipeline.device_recon import (prep_batch,
                                                        to_torch_inputs)
    _, _, drs = decode_capture(name)
    drs = [dr for dr in drs if dr.supported()]
    intra = [dr for dr in drs if dr._inter_plan is None][:4]
    batches = [[dr] for dr in drs] + ([intra] if len(intra) > 1 else [])
    return [to_torch_inputs(prep_batch(b), "cuda") for b in batches]


def _check_on_card(inputs, runs, what):
    """`runs` kernel scans of the batch from its buffer after the MC
    pass, each byte-equal to the plain scan on the card, one launch a
    run whose counters report every level with lanes complete."""
    from av1dec_tpu_torch.ops.kernels import wavefront as W
    from av1dec_tpu_torch.pipeline.device_recon import batch_residuals
    frame = _mc_frame(inputs)
    plain = frame.clone()
    args = (inputs["packed"], batch_residuals(inputs), inputs["pal"],
            inputs["config"])
    W._scan_plain(plain, *args, inputs["windows"])
    levels = int((inputs["levels"][1] > 0).sum())
    for run in range(runs):
        got = frame.clone()
        before = W.launches
        W.scan_into(got, *args, inputs["windows"], inputs["levels"])
        assert W.launches - before == int(levels > 0), what
        torch.cuda.synchronize()
        assert torch.equal(got[:-1], plain[:-1]), (what, run)
        if levels:
            assert W.levels_completed() == levels, (what, run)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run with `pytest -m gpu` on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", small_streams())
def test_cuda_kernel_matches_plain(name):
    """The kernel (`scan_into` on the card, one launch per batch with
    lanes) == the plain scan on the card, byte for byte, on every frame
    of the stream that the device path takes (with its MC pass), and on
    its first up to 4 intra frames as one batch."""
    _need_card()
    for inputs in _card_batches(name):
        _check_on_card(inputs, 1, name)


@pytest.mark.gpu
def test_cuda_kernel_repeated():
    """50 runs of the kernel on each batch of every small stream, each
    byte-equal to the plain scan: a stale edge pixel (a lane that read
    the frame before a lane it depends on published) shows only on
    some runs."""
    _need_card()
    for name in small_streams():
        for inputs in _card_batches(name):
            _check_on_card(inputs, 50, name)
