"""Host spans and copy counters of the port's decode, always on.

A span is a fixed name of NAMES, entered as a context manager
(`with span("prep"):`) or a decorator (`@traced("prep")`).  It reads
`time.perf_counter` as it opens and closes, the clock the benchmark's
device traces are aligned to, so the program's spans and a trace's
device intervals share one clock.

- Each thread keeps its own stack of open spans: a span's parent is the
  innermost open span of its thread, and its self time is its duration
  less the durations of its children.
- Work is done for a `Unit`: a frame of `api.Decoder`, a batch of
  `api.decode_stream_batched`.  `with unit(u):` makes `u` the thread's
  unit; each span that closes adds its self time to its unit's totals
  (`Unit.spans`, seconds by name), and each copy through `to_device` or
  `to_host` its bytes (`Unit.counts`).  A thread pool does not carry the
  unit over: the code that submits work passes it.  A span outside any
  unit still keeps the stack, and adds to no totals.
- Only inside `with collect() as records:` is a span also recorded, as
  `(name, thread ident, t0, t1, decoder id, frame, parent index)`: the
  first four fields are the (name, thread, start, end) of the
  benchmark's host spans; decoder id and frame are the unit's; the
  parent index is the parent's position in `records` (None for a span
  with no recorded parent).  Outside `collect()` nothing is kept.
- ACCUMULATED spans (thousands a frame) add to their unit's totals and
  to their parent's children, and are never recorded.

Copies: every host-to-device and device-to-host copy of the decode goes
through `to_device` and `to_host`, which count, for a card, the copies
and bytes into the unit's `h2d_copies`, `h2d_bytes`, `d2h_copies` and
`d2h_bytes`.

A unit is used by one thread at a time; spans of several threads may
run under different units at once.
"""
import contextlib
import functools
import itertools
import threading
import time

import torch

# the spans; a dotted name runs inside the span its prefix names, but
# `host.residuals`, `host.filter` and `host.inter_pred` run inside
# `host.walk` (`recon.run_host`)
NAMES = (
    "parse",        # NativeParser.parse_tu of a temporal unit
    "decode",       # a frame of Decoder.decode: its `ms`
    "schedule",     # wavefront.build_schedule (DeviceRecon)
    "eligibility",  # device_inter.ineligible_reason (DeviceRecon)
    "inter_plan", "inter_plan.refs", "inter_plan.lanes",  # InterPlan
    "prep", "prep.residuals", "prep.rows", "prep.deblock_maps",
    "upload", "upload.plan", "upload.mc",  # to_torch_inputs
    "upload.residuals",
    "dispatch", "dispatch.scan", "dispatch.post_args",
    "fetch", "fetch.copy", "fetch.widen", "fetch.tail",  # DeviceRecon.fetch
    "host", "host.walk", "host.residuals", "host.filter",  # FrameRecon
    "host.inter_pred",  # InterPredictor.predict_block (accumulated)
    "emit",         # Decoder._emit: film grain, OutputFrame
)
ACCUMULATED = frozenset({"host.inter_pred"})
COPIES = ("h2d_copies", "h2d_bytes", "d2h_copies", "d2h_bytes")
# host-path inter blocks by motion kind (InterPredictor.predict_block)
BLOCKS = ("blocks.simple", "blocks.obmc", "blocks.local_warp",
          "blocks.global_warp")
# device MC lanes built by InterPlan._build_lanes, and the sub-8x8
# chroma pieces among them
LANES = ("lanes.rows", "lanes.pieces")
# "refs.bytes": the bytes of reference samples device_inter.pack_ref_flat
# packs for MC, at the width MC reads them (1 a sample at 8 bits, 4 above)
# transform blocks with a residual whose levels prep_batch packed for the
# device's residuals ("residuals.card"), and those of batches that took
# the NumPy route (a quantizer matrix or a lossless block)
RESIDUALS = ("residuals.card", "residuals.numpy")
COUNTERS = COPIES + BLOCKS + LANES + ("refs.bytes",) + RESIDUALS

_clock = time.perf_counter


class _Thread(threading.local):
    """A thread's open spans, its unit, and the duration of the span
    that closed last."""

    def __init__(self):
        self.stack = []
        self.unit = None
        self.last = 0.0


_local = _Thread()
_ids = itertools.count()
_records = None          # the list of the open collect(), or None
_records_lock = threading.Lock()


def new_id():
    """A fresh decoder id of this process."""
    return next(_ids)


class Unit:
    """The totals of one frame or batch: `spans` (name -> self seconds)
    and `counts` (each of COUNTERS)."""
    __slots__ = ("decoder", "frame", "spans", "counts")

    def __init__(self, decoder, frame):
        self.decoder = decoder
        self.frame = frame
        self.spans = {}
        self.counts = dict.fromkeys(COUNTERS, 0)

    def total(self, names):
        """Seconds of the spans `names` (self times)."""
        s = self.spans
        return sum(s.get(n, 0.0) for n in names)

    def spans_ms(self):
        """{name: self time in ms} of the spans that ran."""
        return {k: round(v * 1e3, 4) for k, v in self.spans.items()}


class _Span:
    """One per name (`span`): the state of an open span lives on its
    thread's stack as [name, t0, children's seconds, records list,
    record index, index children take as parent]."""
    __slots__ = ("name", "recorded")

    def __init__(self, name):
        self.name = name
        self.recorded = name not in ACCUMULATED

    def __enter__(self):
        st = _local.stack
        parent = st[-1][5] if st else None
        records, idx = _records, None
        if records is not None and self.recorded:
            with _records_lock:
                records.append(None)
                idx = len(records) - 1
        st.append([self.name, _clock(), 0.0, records, idx,
                   parent if idx is None else idx])
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        st = _local.stack
        name, t0, child, records, idx, _ = st.pop()
        d = _local.last = t1 - t0
        if st:
            st[-1][2] += d
        u = _local.unit
        if u is not None:
            s = u.spans
            s[name] = s.get(name, 0.0) + d - child
        if idx is not None:
            records[idx] = (name, threading.get_ident(), t0, t1,
                            None if u is None else u.decoder,
                            None if u is None else u.frame,
                            st[-1][5] if st else None)
        return False


_SPANS = {n: _Span(n) for n in NAMES}


def span(name):
    """The span `name` of NAMES, a context manager (KeyError for a name
    outside the list)."""
    return _SPANS[name]


def last_seconds():
    """The duration of the span that last closed on this thread."""
    return _local.last


def traced(name):
    """Decorator: each call of the function runs inside span `name`."""
    sp = _SPANS[name]

    def deco(fn):
        if not sp.recorded:
            return _accumulated(name, fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with sp:
                return fn(*args, **kwargs)
        return wrapper
    return deco


def _accumulated(name, fn):
    """`fn` timed as the ACCUMULATED span `name`: the span's bookkeeping
    without its record, for a function called thousands of times a
    frame (it opens no span of its own inside)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = _clock()
        try:
            return fn(*args, **kwargs)
        finally:
            d = _clock() - t0
            loc = _local
            if loc.stack:
                loc.stack[-1][2] += d
            u = loc.unit
            if u is not None:
                u.spans[name] = u.spans.get(name, 0.0) + d
    return wrapper


@contextlib.contextmanager
def unit(u):
    """Inside the block, the thread's spans and copies add to Unit `u`."""
    prev = _local.unit
    _local.unit = u
    try:
        yield u
    finally:
        _local.unit = prev


@contextlib.contextmanager
def collect():
    """Inside the block every span of every thread is recorded (see the
    module); yields the list of records.  Not nested."""
    global _records
    if _records is not None:
        raise RuntimeError("tracing.collect() is already open")
    _records = records = []
    try:
        yield records
    finally:
        _records = None


def count(name, n=1):
    """Adds `n` to counter `name` of COUNTERS in the thread's unit."""
    u = _local.unit
    if u is not None:
        u.counts[name] += n


def _on_card(device):
    return device.type == "cuda"


def _copied(kind, nbytes):
    u = _local.unit
    if u is not None and nbytes:
        c = u.counts
        c[kind + "_copies"] += 1
        c[kind + "_bytes"] += nbytes


def to_device(a, device, dtype=None):
    """`torch.as_tensor(a, dtype, device)`, counted as one host-to-device
    copy when `device` is a card and `a` is on the host."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    if _on_card(t.device) and \
            (not torch.is_tensor(a) or a.device.type == "cpu"):
        _copied("h2d", t.nbytes)
    return t


def to_host(t):
    """`t.cpu()`, counted as one device-to-host copy when `t` is on a
    card."""
    if _on_card(t.device):
        _copied("d2h", t.nbytes)
    return t.cpu()
