"""The trace helpers of `av1dec_tpu_torch.profiling` on made-up traces:
what lies between the markers is kept, and a trace that lost records is
taken again (the profiler itself needs the card)."""
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
    that lost a marker); returns the waits it was asked for."""
    calls = []

    def fake(fn, iters, settle):
        calls.append(settle)
        ev = traces[len(calls) - 1]
        return None if ev is None else profiling.between_markers(ev)
    monkeypatch.setattr(profiling, "device_events", fake)
    return calls


def test_complete_events_named_retakes_lost_traces(monkeypatch):
    lost_run = _trace(5)[:12] + _trace(5)[14:]  # two kernels lost
    calls = _replay(monkeypatch, [None, lost_run, _trace(5, marks=(1, 0)),
                                  _trace(5)])
    ev, n = profiling.complete_events(None, 5, KERNEL)
    s = profiling.SETTLE_S
    assert (n, calls) == (4, [s, 2 * s, 4 * s, 8 * s])
    assert sum(KERNEL in e.name for e in ev) == 5


def test_complete_events_unnamed_needs_two_equal_counts(monkeypatch):
    short = _trace(5)[:12] + _trace(5)[13:]
    calls = _replay(monkeypatch, [_trace(5), short, _trace(5)])
    ev, n = profiling.complete_events(None, 5)
    assert (n, len(calls), len(ev)) == (3, 3, 5)


def test_complete_events_collective_verdict(monkeypatch):
    # this rank's traces are whole; the group's first verdict is not
    _replay(monkeypatch, [_trace(3)] * 3)
    verdicts = iter([False, True])
    seen = []

    def agree(ok):
        seen.append(ok)
        return next(verdicts) and ok
    ev, n = profiling.complete_events(None, 3, KERNEL, agree)
    assert (n, seen, len(ev)) == (2, [True, True], 3)


@pytest.mark.parametrize("name", [KERNEL, None])
def test_complete_events_gives_up(monkeypatch, name):
    # named: every trace lost a marker; unnamed: no two counts agree
    traces = [None if name else _trace(i) for i in range(profiling.ATTEMPTS)]
    calls = _replay(monkeypatch, traces)
    with pytest.raises(RuntimeError, match="lost records"):
        profiling.complete_events(None, 5, name)
    assert len(calls) == profiling.ATTEMPTS
    assert max(calls) == 32 * profiling.SETTLE_S
