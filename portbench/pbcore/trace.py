"""The traced window: device intervals from torch.profiler between two
marker kernels, checked whole against the launches counted on the host.

The logic of the port's `profiling.py` (a wait once the trace has
started, a marker kernel, the calls, a second marker; only what lies
between the markers is kept), copied so that the yardstick does not move
with the program.  torch.profiler may start recording late and lose a
trace's first records, so a trace counts as whole only when it kept both
markers and, for every kernel launched through `cuda_build.launch`,
exactly as many of its device intervals as the host counted launches.  A
trace that is not whole is never read as a short one: `run.py` traces a
shorter window again, and where that fails too times each launch from
CUDA events (`EventTimer`)."""
import re
import threading
import time
from dataclasses import dataclass, field

MARKER = "spin_kernel"   # the kernel torch.cuda._sleep launches
MARK_CYCLES = 1000
# cycles of the spin kernel queued before each launch that EventTimer
# times (about 0.5 ms at 1.98 GHz, far longer than the host takes to
# queue the launch), so that its events bracket the kernel alone
SPIN_CYCLES = 1_000_000


def kernel_matcher(names):
    """device kernel name -> the `cuda_build` kernel it belongs to, or
    None.  `names`: {kernel name: entries}; a kernel's CUDA function is
    `<name>_kernel` or `<entry>_kernel` (`csrc/*.cu`)."""
    pats = [(k, re.compile(r"\b" + re.escape(stem) + r"_kernel\b"))
            for k, entries in names.items() for stem in (k, *entries)]

    def match(device_name):
        for k, p in pats:
            if p.search(device_name):
                return k
        return None
    return match


@dataclass
class Trace:
    whole: bool
    why: str = ""      # why a trace is not whole
    copies: bool = True  # copies and idle gaps seen (a profiler trace)
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)   # kernel -> seconds
    kernel_n: dict = field(default_factory=dict)   # kernel -> intervals
    ops: list = field(default_factory=list)        # [[name, seconds]]
    gaps: list = field(default_factory=list)       # [[span, seconds]]


def short(name):
    n = name[5:] if name.startswith("void ") else name
    for c in "<(":
        n = n.split(c)[0]
    return n[:60] or name[:60]


def profile_calls(run_calls, settle):
    """Runs `run_calls()` under torch.profiler (device activity only),
    `settle` seconds after it started, between two marker kernels.
    Returns (device events [(name, start us, end us)], host seconds
    when the first marker had ended)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        run_calls()
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events() if e.device_type == DeviceType.CUDA]
    return ev, h0


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(ev, h0, launches, entries, spans):
    """The Trace of a `profile_calls` trace.  `launches`: kernel ->
    launches the host counted; `entries`: kernel -> its C entries;
    `spans`: the host spans (name, thread, t0, t1)."""
    marks = sorted((e for e in ev if MARKER in e[0]), key=lambda e: e[1])
    if len(marks) != 2:
        return Trace(False, f"{len(marks)} marker kernels kept, not 2")
    w0, w1 = marks[0][2], marks[1][1]
    inside = [e for e in ev if MARKER not in e[0] and e[1] >= w0 and
              e[2] <= w1]
    match = kernel_matcher(entries)
    t = Trace(True, window_s=(w1 - w0) / 1e6)
    by_op = {}
    for name, s, e in inside:
        k = match(name)
        if k is not None:
            t.kernel_s[k] = t.kernel_s.get(k, 0.0) + (e - s) / 1e6
            t.kernel_n[k] = t.kernel_n.get(k, 0) + 1
        label = k or short(name)
        by_op[label] = by_op.get(label, 0.0) + (e - s) / 1e6
    if t.kernel_n != {k: n for k, n in launches.items() if n}:
        return Trace(False, f"kernel intervals {t.kernel_n} != launches "
                            f"{launches}")
    busy = _union([(s, e) for _, s, e in inside])
    t.busy_s = sum(e - s for s, e in busy) / 1e6
    t.ops = sorted(([k, v] for k, v in by_op.items()),
                   key=lambda kv: -kv[1])[:10]
    # idle gaps, each put to the host span active at its middle (the
    # innermost on the main thread, else on another thread)
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    main = threading.main_thread().ident
    by_span = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = h0 + ((a + b) / 2 - w0) / 1e6
        live = [sp for sp in spans if sp[2] <= mid <= sp[3]]
        live.sort(key=lambda sp: (sp[1] != main, sp[3] - sp[2]))
        label = live[0][0] if live else "outside spans"
        by_span[label] = by_span.get(label, 0.0) + (b - a) / 1e6
    t.gaps = sorted(([k, v] for k, v in by_span.items()),
                    key=lambda kv: -kv[1])[:10]
    return t


class EventTimer:
    """`spans.Instrument(on_launch=...)`'s launch for the fallback: CUDA
    events around each launch, behind a spin kernel (SPIN_CYCLES) so
    that the events bracket the kernel alone."""

    def __init__(self):
        self.pairs = []   # (kernel, start event, end event)

    def __call__(self, name, entry, device, real, args):
        import torch
        stream = torch.cuda.current_stream(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            torch.cuda._sleep(SPIN_CYCLES)
        a.record(stream)
        real(name, entry, device, *args)
        b.record(stream)
        self.pairs.append((name, a, b))

    def trace(self, window_s):
        """A Trace of the kernels alone: no copies, no idle gaps."""
        import torch
        torch.cuda.synchronize()
        t = Trace(True, copies=False, window_s=window_s)
        for k, a, b in self.pairs:
            s = a.elapsed_time(b) / 1e3
            t.kernel_s[k] = t.kernel_s.get(k, 0.0) + s
            t.kernel_n[k] = t.kernel_n.get(k, 0) + 1
        t.busy_s = sum(t.kernel_s.values())
        t.ops = sorted(([k, v] for k, v in t.kernel_s.items()),
                       key=lambda kv: -kv[1])[:10]
        return t
