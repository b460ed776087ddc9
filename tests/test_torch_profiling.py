"""The trace helpers of `av1dec_tpu_torch.profiling` on made-up traces:
what lies between the markers is kept, a trace that lost records is
taken again, and where no trace of a named kernel is whole, the last
such kernels a trace kept are taken; where none kept them,
`chip_smoke.traced` and the sharded worker time the kernels from CUDA
events around each launch, behind a spin kernel, where fn launches any
(`profiling.launch_ms`), else the calls queued behind a spin kernel (the
profiler and CUDA events themselves need the card)."""
from types import SimpleNamespace

import pytest

from av1dec_tpu_torch import profiling

KERNEL = "cdef_shard_kernel"


def _event(name, start, end):
    return SimpleNamespace(name=name,
                           time_range=SimpleNamespace(start=start, end=end))


def _trace(n, lead=profiling.LEAD, name=KERNEL, marks=(True, True)):
    """A trace of `lead` calls, a marker, `n` calls and a marker, 10 us
    apart; a marker whose flag is False was lost."""
    ev, t = [], 0
    for i in range(lead + n + 2):
        if i == lead or i == lead + n + 1:
            if marks[i != lead]:
                ev.append(_event("at::cuda::spin_kernel", t, t + 5))
        else:
            ev.append(_event(f"void {name}<32>", t, t + 5))
        t += 10
    return ev


@pytest.mark.parametrize("marks", [(True, True), (False, True),
                                   (True, False), (False, False)])
def test_between_markers(marks):
    ev = _trace(4, marks=marks)
    got = profiling.between_markers(list(reversed(ev)))
    if marks != (True, True):
        assert got is None
        return
    assert len(got) == 4
    assert all(KERNEL in e.name for e in got)
    assert sorted(e.time_range.start for e in got) == [110, 120, 130, 140]


def _replay(monkeypatch, traces):
    """profiling.device_events hands out `traces` in turn (None: a trace
    that kept nothing); returns the waits it was asked for."""
    calls = []

    def fake(fn, iters, settle):
        calls.append(settle)
        return traces[len(calls) - 1] or []
    monkeypatch.setattr(profiling, "device_events", fake)
    return calls


def test_complete_events_named_retakes_lost_traces(monkeypatch):
    lost_run = _trace(5)[:12] + _trace(5)[14:]  # two kernels lost
    calls = _replay(monkeypatch, [None, lost_run, _trace(5, marks=(1, 0)),
                                  _trace(5)])
    ev, n, whole = profiling.complete_events(None, 5, KERNEL)
    s = profiling.SETTLE_S
    assert (n, whole, calls) == (4, True, [s, 2 * s, 4 * s, 8 * s])
    assert sum(KERNEL in e.name for e in ev) == 5


def test_complete_events_unnamed_needs_two_equal_counts(monkeypatch):
    short = _trace(5)[:12] + _trace(5)[13:]
    calls = _replay(monkeypatch, [_trace(5), short, _trace(5)])
    ev, n, whole = profiling.complete_events(None, 5)
    assert (n, len(calls), len(ev), whole) == (3, 3, 5, True)


def test_complete_events_collective_verdict(monkeypatch):
    # this rank's traces are whole; the group's first verdict is not
    _replay(monkeypatch, [_trace(3)] * 3)
    verdicts = iter([False, True])
    seen = []

    def agree(ok):
        seen.append(ok)
        return next(verdicts) and ok
    ev, n, whole = profiling.complete_events(None, 3, KERNEL, agree)
    assert (n, seen, len(ev), whole) == (2, [True, True], 3, True)


@pytest.mark.parametrize("name", [KERNEL, None])
def test_complete_events_gives_up(monkeypatch, name):
    # named: every trace lost a marker and kept fewer than 5 kernels;
    # unnamed: no two counts agree
    traces = [_trace(5, marks=(False, True))[12:] if name else _trace(i)
              for i in range(profiling.ATTEMPTS)]
    calls = _replay(monkeypatch, traces)
    with pytest.raises(profiling.RecordsLost, match="lost records"):
        profiling.complete_events(None, 5, name)
    assert len(calls) == profiling.ATTEMPTS
    assert max(calls) == 32 * profiling.SETTLE_S


@pytest.mark.parametrize("cut", [0, 6, 10])
def test_complete_events_named_falls_back_to_the_last_kernels(monkeypatch,
                                                              cut):
    """No trace kept its first marker (and `cut` lead kernels were lost
    too); the first trace with 5 kernels gives its last 5, in order."""
    lost = [_trace(5, marks=(False, True))[cut:]
            for _ in range(profiling.ATTEMPTS)]
    lost[0] = lost[0][:3]  # too few kernels: not the fallback
    calls = _replay(monkeypatch, lost)
    ev, n, whole = profiling.complete_events(None, 5, KERNEL)
    assert (n, whole, len(calls)) == (profiling.ATTEMPTS, False,
                                      profiling.ATTEMPTS)
    assert sorted(e.time_range.start for e in ev) == [110, 120, 130, 140,
                                                      150]
    # the group falls back only together
    _replay(monkeypatch, lost)
    with pytest.raises(RuntimeError, match="lost records"):
        profiling.complete_events(None, 5, KERNEL, lambda ok: False)


def test_tail_events_without_the_last_marker():
    ev = _trace(5, marks=(False, False))
    got = profiling.tail_events(ev, KERNEL, 5)
    assert sorted(e.time_range.start for e in got) == [110, 120, 130, 140,
                                                       150]
    assert profiling.tail_events(ev, KERNEL, 16) is None


def test_kernel_ms_times_queued_calls_when_every_trace_lost_records(
        monkeypatch, capsys):
    """`chip_smoke.kernel_ms` (one kernel a call) and `chip_smoke.traced`
    (any calls): where every trace lost records, the kernels are timed
    from CUDA events around each launch, or where fn launched none
    through `cuda_build.launch`, the calls queued behind a spin kernel;
    the kernels are not counted, and the log says so; other errors pass
    through."""
    from torch_port_helpers import _ROOT
    monkeypatch.syspath_prepend(_ROOT)
    import chip_smoke as cs
    asked = []

    def lost(fn, iters, name=None):
        asked.append(name)
        raise profiling.RecordsLost("the profiler lost records")
    monkeypatch.setattr(cs, "_device_events", lost)
    monkeypatch.setattr(cs, "queued_ms", lambda fn, iters: 0.25 + iters)
    monkeypatch.setattr(profiling, "launch_ms", lambda fn, iters: None)
    assert cs.kernel_ms(None, KERNEL, 50) == 50.25
    assert cs.traced(None, "deblock", 3, one_each=False) == (3.25, None,
                                                             3.25)
    monkeypatch.setattr(profiling, "launch_ms",
                        lambda fn, iters: (0.125, 1.0))
    assert cs.kernel_ms(None, KERNEL, 50) == 0.125
    assert cs.traced(None, KERNEL, 3) == (3.25, None, 0.125)
    # one kernel a call: a trace is whole by its count of that kernel
    assert asked == [KERNEL, None, KERNEL, KERNEL]
    out = capsys.readouterr().out
    assert "lost records" in out and "queued behind a spin kernel" in out
    assert "around each launch behind a spin kernel 0.125 ms" in out

    def broken(*_):
        raise RuntimeError("CUDA error")
    monkeypatch.setattr(cs, "_device_events", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cs.kernel_ms(None, KERNEL, 50)


def test_sharded_worker_times_shard_calls_when_every_trace_lost_records(
        monkeypatch):
    """The sharded worker's `_time_cdef`: where every rank's traces lost
    records, each launch is timed with CUDA events instead
    (`profiling.launch_ms`), and its record says so."""
    from av1dec_tpu_torch.parallel import worker

    def lost(*_):
        raise profiling.RecordsLost("the profiler lost records")
    monkeypatch.setattr(profiling, "complete_events", lost)
    monkeypatch.setattr(profiling, "launch_ms",
                        lambda call, iters: (0.5 + iters, 1.0))
    rec = worker._time_cdef(None, None, 8, None, 4)
    assert rec == {"kernel_ms": 4.5, "kernels_per_call": 1.0,
                   "kernel_timed_by": "CUDA events around each launch",
                   "halo_ms": 0.0}


def test_launch_ms_is_none_when_nothing_launched():
    """`profiling.launch_ms` restores every module's `launch` and gives
    None when fn launched no kernel through `cuda_build.launch` (as the
    plain versions and another checkout's wrappers)."""
    from av1dec_tpu_torch.ops.kernels import cuda_build, deblock
    real = cuda_build.launch
    seen = []

    def fn():
        seen.append(deblock.launch is not real)
    assert profiling.launch_ms(fn, 3) is None
    assert seen == [True] * 3
    assert deblock.launch is real and cuda_build.launch is real
