"""Device intervals of a function's calls on the card, from torch.profiler.

The profiler starts recording late: a trace may lose the launches made
in its first milliseconds, and a short trace that starts after the
process was idle for a while may hold nothing but its last kernel (on
an H100 under torch 2.11, most such traces late in `chip_smoke.py`).  So
`device_events` waits `settle` seconds once the trace has started,
makes lead calls and launches a marker kernel (`torch.cuda._sleep`),
then the calls it times and a second marker, and keeps only what lies
between the two markers; `complete_events` takes the trace again, with
a longer wait each time, until what it kept is whole.
"""
import time

MARKER = "spin_kernel"  # the kernel that torch.cuda._sleep launches
LEAD = 10  # calls of fn() before the first marker
SETTLE_S = 0.05  # seconds a trace waits before its first call
ATTEMPTS = 10  # traces `complete_events` takes before it gives up


def device_events(fn, iters, settle=SETTLE_S):
    """The device events (kernels and copies) of the last `iters` of
    `LEAD + iters` calls of fn() in one torch.profiler trace, made
    `settle` seconds after it started: those that lie between the marker
    kernels launched before and after them.  None if the trace lost
    either marker."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        for _ in range(LEAD):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return between_markers([e for e in prof.events()
                            if e.device_type == DeviceType.CUDA])


def between_markers(ev):
    """The events of `ev` that lie between its two marker kernels; None
    unless it holds exactly two."""
    marks = sorted((e for e in ev if MARKER in e.name),
                   key=lambda e: e.time_range.start)
    if len(marks) != 2:
        return None
    first, last = marks[0].time_range.end, marks[1].time_range.start
    return [e for e in ev if MARKER not in e.name and
            e.time_range.start >= first and e.time_range.end <= last]


def complete_events(fn, iters, name=None, agree=None):
    """(`device_events(fn, iters, settle)` of a trace that lost nothing,
    the number of traces taken); each trace waits twice as long as the
    one before, up to 32 x SETTLE_S.

    With `name` (fn launches one kernel whose name holds it), a trace is
    whole when it kept both markers and `iters` such kernels.  Without
    it, what fn runs is not known beforehand, so a trace is whole when
    an earlier one kept as many events: a lost record only lowers the
    count.  Where the calls are collective, `agree(ok)` turns this
    process's verdict into its group's, so that every rank takes its
    trace again together.  Raises RuntimeError after ATTEMPTS traces."""
    counts = []
    for n in range(1, ATTEMPTS + 1):
        ev = device_events(fn, iters, SETTLE_S * 2 ** min(n - 1, 5))
        if ev is None:
            ok = False
        elif name is not None:
            ok = sum(name in e.name for e in ev) == iters
        else:
            ok = len(ev) in counts
            counts.append(len(ev))
        if agree is not None:
            ok = agree(ok)
        if ok:
            return ev, n
    what = f"{iters} {name} kernels" if name else \
        f"as many events twice (counts {counts})"
    raise RuntimeError(f"the profiler lost records in each of {ATTEMPTS} "
                       f"traces of {iters} calls: no marker pair and "
                       f"{what}")
