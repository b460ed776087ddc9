"""The port's spans and copy counters (`av1dec_tpu_torch/tracing.py`):
the per-frame totals of `Decoder.stats`, the records of `collect()`,
the stages of `decode_stream_batched(timings=...)` and the copy helpers,
on the CPU."""
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import parse, tus

from av1dec_tpu_torch import tracing

OUTSIDE_DECODE = ("parse", "emit")


def _self_ms(records):
    """Self ms of each record, its recorded children's durations
    subtracted (accumulated spans are no records: their time stays in
    their parent's)."""
    own = [r[3] - r[2] for r in records]
    for r in records:
        if r[6] is not None:
            own[r[6]] -= r[3] - r[2]
    return own


def _check_records(records, t0, t1):
    assert records and None not in records
    for i, r in enumerate(records):
        assert len(r) == 7
        name, thread, a, b, decoder, frame, parent = r
        assert name in tracing.NAMES and name not in tracing.ACCUMULATED
        assert t0 <= a <= b <= t1
        if parent is not None:
            p = records[parent]
            # a parent opens first, on the same thread, around its child
            assert parent < i and p[1] == thread
            assert p[2] <= a and b <= p[3]
            assert (p[4], p[5]) == (decoder, frame)


def _decode(name, device="cpu"):
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.config import DecoderConfig
    dec = api.Decoder(DecoderConfig(apply_grain=False), device=device)
    out = []
    for tu in tus(name):
        out += dec.decode(tu)
    dec.close()
    return dec, out


@pytest.mark.parametrize("name,path", [("lowdelay", "device"),
                                       ("obmc", "host")])
def test_decoder_records(native_lib, name, path):
    """Every record of a stream with inter frames on the device path
    (`lowdelay`) and on the host pixel path (`obmc`): its index, its
    spans' self times summing to `ms`, `inter_plan_ms` from its spans,
    MC lanes counted where an InterPlan ran, no copies on the CPU, a
    device-path frame's transform blocks with a residual (eob > 0)
    counted as sent to the device, none on the host path; and
    `collect()`'s records of the decode."""
    t0 = time.perf_counter()
    with tracing.collect() as records:
        dec, _ = _decode(name)
    t1 = time.perf_counter()
    stats = dec.stats
    assert [s["frame"] for s in stats] == list(range(len(stats)))
    assert tracing.RESIDUALS == ("residuals.card", "residuals.numpy")
    assert set(tracing.RESIDUALS) <= set(tracing.COUNTERS)
    coded = [int((p.tx[:, 5] > 0).sum()) for _, _, p in parse(name, "torch")]
    assert len(coded) == len(stats)
    for s, n in zip(stats, coded):
        assert s["residual_blocks"] == (
            {"card": n, "numpy": 0} if s["recon_path"] == "device" else
            {"card": 0, "numpy": 0})
    assert any(not s["intra"] and s["recon_path"] == path for s in stats)
    for s in stats:
        spans = s["spans_ms"]
        assert set(spans) <= set(tracing.NAMES)
        assert all(v >= 0 for v in spans.values())
        assert "decode" in spans
        inside = sum(v for k, v in spans.items() if k not in OUTSIDE_DECODE)
        assert abs(inside - s["ms"]) < 0.1
        plan = sum(v for k, v in spans.items() if k.startswith("inter_plan"))
        assert abs(plan - s["inter_plan_ms"]) < 0.01
        if "inter_plan" in spans:
            assert not s["intra"] and s["recon_path"] == "device"
        assert ("host.walk" in spans) == (s["recon_path"] == "host")
        assert all(s[k] == 0 for k in tracing.COPIES)
        if sum(s["inter_blocks"].values()):
            assert not s["intra"] and s["recon_path"] == "host"
        # MC lanes are built exactly where an InterPlan is
        lanes = s["inter_lanes"]
        assert (lanes["rows"] > 0) == ("inter_plan" in spans)
        assert 0 <= lanes["pieces"] <= lanes["rows"]
    assert stats[0]["spans_ms"]["parse"] > 0
    # an inter frame of the stream's path has an InterPlan, or inter
    # blocks on the host pixel path
    assert any("inter_plan" in s["spans_ms"] if path == "device" else
               sum(s["inter_blocks"].values()) for s in stats)
    _check_records(records, t0, t1)
    assert {r[4] for r in records} == {dec._id}
    assert {r[5] for r in records} == {s["frame"] for s in stats}
    # the records' self times are the totals' (host.inter_pred's time
    # stays in host.walk's record)
    own = _self_ms(records)
    for s in stats:
        got = {}
        for r, ms in zip(records, own):
            if r[5] == s["frame"]:
                got[r[0]] = got.get(r[0], 0.0) + ms * 1e3
        want = dict(s["spans_ms"])
        want["host.walk"] = want.get("host.walk", 0.0) + \
            want.pop("host.inter_pred", 0.0)
        assert set(got) == {k for k, v in want.items() if v or k in got}
        for k, v in got.items():
            assert abs(v - want[k]) < 0.01, (s["frame"], k)
    # outside collect() nothing is kept
    n = len(records)
    _decode(name)
    assert len(records) == n
    # the records still pickle, for the GOP workers
    assert pickle.loads(pickle.dumps(stats)) == stats


@pytest.mark.parametrize("name,n_tus,batches,host", [("multi", 2, 2, 0),
                                                      ("screen", 1, 0, 1)])
def test_batched_stages_and_worker_thread(native_lib, name, n_tus, batches,
                                          host):
    """`timings` has the keys of STAGES, each the self time of its
    spans; the prep worker's spans carry its own thread and its batch's
    unit.  `multi`: two device-path frames, one a batch; `screen`'s TU 0:
    an intra block copy key frame (host pixel path)."""
    from av1dec_tpu_torch import api
    tm = {}
    with tracing.collect() as records:
        t0 = time.perf_counter()
        out = api.decode_stream_batched(tus(name)[:n_tus], device="cpu",
                                        batch=1, timings=tm)
        t1 = time.perf_counter()
    assert len(out) == batches + host
    assert list(tm) == list(api.STAGES)
    assert (tm["host_path"] > 0) == bool(host)
    assert (tm["host_prep"] > 0) == bool(batches)
    assert tm["parse"] > 0
    _check_records(records, t0, t1)
    own = _self_ms(records)
    for stage, names in api.STAGE_SPANS.items():
        want = sum(ms for r, ms in zip(records, own) if r[0] in names)
        assert abs(tm[stage] - want) < 1e-6, stage
    main = threading.get_ident()
    prep = [r for r in records if r[0].startswith("prep")]
    assert all(r[1] != main for r in prep)
    assert sorted({r[5] for r in prep if r[0] == "prep"}) == \
        list(range(batches))
    assert all(r[1] == main for r in records if not r[0].startswith("prep"))
    assert len({r[4] for r in records}) == 1


def test_spans_self_times_and_threads():
    """Self time is the duration less the children's, an accumulated
    span is subtracted but not recorded, each thread has its own stack,
    and names outside the list are refused."""
    u = tracing.Unit(7, 3)
    with tracing.collect() as records, tracing.unit(u):
        with tracing.span("host"):
            with tracing.span("host.walk"):
                with tracing.span("host.inter_pred"):
                    time.sleep(0.002)
                time.sleep(0.002)
            seen = []

            def other():
                with tracing.span("prep"):
                    seen.append(threading.get_ident())
            th = threading.Thread(target=other)
            th.start()
            th.join(10)
            assert not th.is_alive() and seen
    assert [r[0] for r in records] == ["host", "host.walk", "prep"]
    host, walk, prep = records
    assert prep[1] == seen[0] != host[1] == walk[1]
    assert walk[6] == 0 and host[6] is None
    # the other thread has no unit and no open parent
    assert prep[6] is None and prep[4:6] == (None, None)
    assert (host[4], host[5]) == (7, 3)
    assert u.spans["host.inter_pred"] >= 0.002
    assert abs(u.spans["host.walk"] + u.spans["host.inter_pred"] -
               (walk[3] - walk[2])) < 1e-9
    assert abs(sum(u.spans.values()) - (host[3] - host[2])) < 1e-9
    assert "prep" not in u.spans
    with pytest.raises(KeyError):
        tracing.span("not_a_span")
    with tracing.collect():
        with pytest.raises(RuntimeError):
            with tracing.collect():
                pass


def test_copy_counters(monkeypatch):
    """The helpers count bytes and copies for a card (the device check
    stubbed) and nothing for the CPU or outside a unit."""
    a = np.arange(10, dtype=np.int32)
    u = tracing.Unit(0, 0)
    with tracing.unit(u):
        t = tracing.to_device(a, "cpu")
        tracing.to_host(t)
    assert t.dtype == torch.int32 and t.tolist() == a.tolist()
    assert all(u.counts[k] == 0 for k in tracing.COPIES)
    monkeypatch.setattr(tracing, "_on_card", lambda device: True)
    with tracing.unit(u):
        t = tracing.to_device(a, "cpu")
        tracing.to_device(a, "cpu", dtype=torch.int64)
        host = tracing.to_host(torch.zeros(6, dtype=torch.int64))
        tracing.to_device(np.zeros(0, np.int32), "cpu")   # no bytes
    assert host.shape == (6,)
    assert u.counts["h2d_copies"] == 2 and u.counts["h2d_bytes"] == 120
    assert u.counts["d2h_copies"] == 1 and u.counts["d2h_bytes"] == 48
    tracing.to_device(a, "cpu")      # outside any unit: not counted
    assert u.counts["h2d_copies"] == 2


def test_decoder_copies_on_a_card_stub(native_lib, monkeypatch):
    """With every device taken for a card, each frame counts its copies:
    a device-path frame fetches its three planes, a host-path frame
    its residuals and its CDEF output, one copy each."""
    monkeypatch.setattr(tracing, "_on_card", lambda device: True)
    for name in ("lowdelay", "obmc"):
        dec, frames = _decode(name)
        for s in dec.stats:
            assert s["h2d_copies"] > 0 and s["h2d_bytes"] > 0
            if s["recon_path"] == "device":
                # and the pre-CDEF planes for a host restoration tail
                assert s["d2h_copies"] == 3 or \
                    (s["lr"] and s["d2h_copies"] == 6)
            else:
                assert s["d2h_copies"] == 1 + s["cdef"] and \
                    s["d2h_bytes"] > 0
