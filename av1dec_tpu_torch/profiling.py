"""Device intervals of a function's calls on the card, from torch.profiler.

The profiler starts recording late: a trace may lose the launches made
in its first milliseconds, and a short trace that starts after the
process was idle for a while may hold nothing but its last kernel (on
an H100 under torch 2.11, most such traces late in `chip_smoke.py`).  So
`device_events` waits `settle` seconds once the trace has started,
makes lead calls and launches a marker kernel (`torch.cuda._sleep`),
then the calls it times and a second marker; `complete_events` keeps
only what lies between the two markers, and takes the trace again, with
a longer wait each time, until what it kept is whole.  Where no trace
is whole, the calls of a named kernel are timed from what the traces
kept of their end (`tail_events`); where no trace kept even that,
`complete_events` raises `RecordsLost`, and `launch_ms` times the
calls' kernels from CUDA events around each launch instead.
"""
import sys
import time

MARKER = "spin_kernel"  # the kernel that torch.cuda._sleep launches
LEAD = 10  # calls of fn() before the first marker
SETTLE_S = 0.05  # seconds a trace waits before its first call
ATTEMPTS = 10  # traces `complete_events` takes before it gives up
# cycles of the spin kernel `launch_ms` queues before each launch (about
# 0.5 ms at the H100's 1.98 GHz, far longer than the host takes to
# queue the launch)
SPIN_CYCLES = 1_000_000


class RecordsLost(RuntimeError):
    """Every trace `complete_events` took lost records."""


def device_events(fn, iters, settle=SETTLE_S):
    """The device events (kernels and copies) of one torch.profiler
    trace, made `settle` seconds after it started, of `LEAD` calls of
    fn(), a marker kernel, `iters` calls and a second marker."""
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
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


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


def tail_events(ev, name, iters):
    """The events of `ev` from the start of its last `iters` kernels
    whose name holds `name` (up to its last marker, where that marker
    follows them); None unless it holds that many.  Recording starts
    late, so a trace that lost its first marker keeps the end of what
    ran: the last calls, each one such kernel.  What ran before the
    first of those kernels in its call (a copy) is not kept."""
    named = sorted((e for e in ev if name in e.name),
                   key=lambda e: e.time_range.start)
    if len(named) < iters:
        return None
    first = named[-iters].time_range.start
    last = max((e.time_range.start for e in ev if MARKER in e.name),
               default=None)
    if last is None or last < named[-1].time_range.end:
        last = float("inf")
    return [e for e in ev if MARKER not in e.name and
            e.time_range.start >= first and e.time_range.end <= last]


def complete_events(fn, iters, name=None, agree=None):
    """(the events between the markers of a `device_events(fn, iters,
    settle)` trace that lost nothing, the number of traces taken, True);
    each trace waits twice as long as the one before, up to 32 x
    SETTLE_S.

    With `name` (fn launches one kernel whose name holds it), a trace is
    whole when it kept both markers and `iters` such kernels; when none
    of ATTEMPTS traces is whole, the first trace that kept at least
    `iters` of them gives its `tail_events` instead, and the third value
    is False.  Without it, what fn runs is not known beforehand, so a
    trace is whole when an earlier one kept as many events: a lost
    record only lowers the count.  Where the calls are collective,
    `agree(ok)` turns this process's verdict into its group's, so that
    every rank takes its trace again, and falls back, together.  Raises
    RecordsLost when neither gives events."""
    counts = []
    marks = []  # marker kernels each trace kept
    tail = None
    for n in range(1, ATTEMPTS + 1):
        raw = device_events(fn, iters, SETTLE_S * 2 ** min(n - 1, 5))
        marks.append(sum(MARKER in e.name for e in raw))
        ev = between_markers(raw)
        if name is not None:
            ok = ev is not None and sum(name in e.name for e in ev) == iters
            if not ok and tail is None:
                tail = tail_events(raw, name, iters)
        elif ev is None:
            ok = False
        else:
            ok = len(ev) in counts
            counts.append(len(ev))
        if agree is not None:
            ok = agree(ok)
        if ok:
            return ev, n, True
    if name is not None:
        ok = tail is not None
        if agree is not None:
            ok = agree(ok)
        if ok:
            return tail, ATTEMPTS, False
    what = f"{iters} {name} kernels" if name else \
        f"as many events twice (counts {counts})"
    raise RecordsLost(f"the profiler lost records in each of {ATTEMPTS} "
                       f"traces of {iters} calls: no marker pair and "
                       f"{what}; markers a trace {marks}")


def launch_ms(fn, iters):
    """(mean ms a call, launches a call) of the kernels `iters` calls of
    fn() launch through `cuda_build.launch`, from CUDA events recorded
    around each launch on its device's current stream; None when fn
    launched none.  Each launch waits behind a spin kernel (SPIN_CYCLES),
    so the stream is busy while the host queues the launch and its
    events bracket the kernel alone, in a call that waits for its
    result too.  The stand-in for a trace where every trace lost
    records."""
    import torch

    from av1dec_tpu_torch.ops.kernels import cuda_build
    real = cuda_build.launch
    pairs = []

    def timed(name, entry, device, *args):
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            torch.cuda._sleep(SPIN_CYCLES)
        start.record(stream)
        real(name, entry, device, *args)
        end.record(stream)
        pairs.append((start, end))
    # the kernel modules bind `launch` by name
    mods = [m for m in list(sys.modules.values())
            if getattr(m, "__dict__", {}).get("launch") is real]
    for m in mods:
        m.launch = timed
    try:
        for _ in range(iters):
            fn()
    finally:
        for m in mods:
            m.launch = real
    if not pairs:
        return None
    torch.cuda.synchronize()
    return (sum(a.elapsed_time(b) for a, b in pairs) / iters,
            len(pairs) / iters)
