"""Drives the port through its public entry points, one call at a time,
and reduces what each call hands back to what the comparison needs.

- `decode_stream_batched`: a call's temporal units in one
  `api.decode_stream_batched(units, device, batch, timings)` call.
- `Decoder`: a fresh `api.Decoder(DecoderConfig(threads=...), device)`
  a call, the stream's units one `decode` at a time, as a player does.

Each frame handed back is reduced at once to the MD5 of its displayed
pixels (`digest`), so that a call's int64 planes are not held through
the window."""
import hashlib
import struct
from dataclasses import dataclass, field

import numpy as np


def read_ivf(path):
    """The temporal units of an IVF file, in order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"DKIF":
        raise ValueError(f"{path}: not an IVF file")
    pos = struct.unpack("<H", data[6:8])[0]
    units = []
    while pos + 12 <= len(data):
        size = struct.unpack("<I", data[pos:pos + 4])[0]
        units.append(data[pos + 12:pos + 12 + size])
        pos += 12 + size
    return units


def digest(planes, ref, control=False):
    """MD5 of a frame's planes cropped to the displayed size of the
    stream's record `ref` (luma height x width, chroma rounded up by the
    subsampling), as uint8 (8-bit) or little-endian uint16 bytes, as
    libaom's MD5s are taken; None when the frame has another number of
    planes, a plane smaller than that, or a pixel outside [0, 2^bd).
    `control`: the lowest bit of every pixel cleared first (a pixel
    path one bit short of the stream's depth)."""
    bd = ref["bit_depth"]
    sx, sy = ref["subsampling"]
    width, height = ref["width"], ref["height"]
    if len(planes) != (1 if ref["mono"] else 3):
        return None
    dt = np.uint8 if bd == 8 else np.dtype("<u2")
    h = hashlib.md5()
    for i, p in enumerate(planes):
        ph = height if i == 0 else (height + sy) >> sy
        pw = width if i == 0 else (width + sx) >> sx
        a = np.asarray(p)
        if a.ndim != 2 or a.shape[0] < ph or a.shape[1] < pw:
            return None
        a = a[:ph, :pw]
        if int(a.min()) < 0 or int(a.max()) >= 1 << bd:
            return None
        if control:
            a = a & ~1
        h.update(np.ascontiguousarray(a, dt).tobytes())
    return h.hexdigest()


@dataclass
class Frame:
    stream: str
    index: int          # the frame's index in libaom's record
    want: str           # libaom's MD5
    got: object = None  # the port's ("" malformed, None never handed back)


@dataclass
class Record:
    """What a run's calls handed back, and what the program said about
    them: stage seconds (`decode_stream_batched(timings=...)`) and
    `Decoder.stats`."""
    frames: list = field(default_factory=list)
    stages: dict = field(default_factory=dict)
    stats: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    call_s: list = field(default_factory=list)  # host seconds a call
    call_cpu_s: list = field(default_factory=list)  # process CPU seconds
    # frames by the recon path the reference's record expects, and by
    # the one the program took ("device" or "host"); frames whose path
    # is not the expected one
    paths_want: dict = field(default_factory=dict)
    paths_took: dict = field(default_factory=dict)
    off_path: int = 0
    paths_n: int = 0   # frames of either list, the longer one's

    def add_paths(self, want, took):
        """`want`: the record's paths of the frames (None: the record
        has none); `took`: the program's."""
        for t in took:
            self.paths_took[t] = self.paths_took.get(t, 0) + 1
        if want is None:
            return
        for w in want:
            self.paths_want[w] = self.paths_want.get(w, 0) + 1
        self.off_path += sum(w != t for w, t in zip(want, took)) + \
            abs(len(want) - len(took))
        self.paths_n += max(len(want), len(took))

    def add_stages(self, tm):
        for k, v in tm.items():
            self.stages[k] = self.stages.get(k, 0.0) + v


class Runner:
    """One cell's entry on one device.  `units`: stream -> its temporal
    units; `refs`: stream -> libaom's record."""

    def __init__(self, config, device, units, refs, control=False):
        self.config = config
        self.device = device
        self.units = units
        self.refs = refs
        self.control = control

    def call(self, call, record, timed_stages=False):
        """Runs one call and appends its frames to `record`; with
        `timed_stages` the batched entry's stage seconds too (the entry
        then synchronises the card after each stage)."""
        from av1dec_tpu_torch import api
        from av1dec_tpu_torch.config import DecoderConfig
        from av1dec_tpu_torch.pipeline.recon import FrameRecon
        ref = self.refs[call.stream]
        tus = self.units[call.stream]
        entry = self.config["entry"]
        if entry == "decode_stream_batched":
            tm = {} if timed_stages else None
            # the batched entry decodes a frame its device path refuses
            # inline on the host pixel path (`FrameRecon.run`)
            host = [0]
            real = FrameRecon.__dict__["run"]

            def run(*args, **kwargs):
                host[0] += 1
                return real(*args, **kwargs)
            FrameRecon.run = run
            try:
                out = api.decode_stream_batched(
                    [tus[u] for u in call.units], device=self.device,
                    batch=int(self.config["batch"]), timings=tm)
            finally:
                FrameRecon.run = real
            if tm is not None:
                record.add_stages(tm)
            got = [digest(p, ref, self.control) or "" for p in out]
            wants = [(u, ref["frames"][u]) for u in call.units]
            paths = ref.get("paths")
            want = None if paths is None else sorted(paths[u]
                                                     for u in call.units)
            record.add_paths(want, sorted(
                ["host"] * host[0] + ["device"] * (len(out) - host[0])))
        elif entry == "Decoder":
            dec = api.Decoder(DecoderConfig(
                threads=int(self.config["threads"]["decoder"])),
                device=self.device)
            got = []
            try:
                for u in call.units:
                    got += [digest(f.planes, ref, self.control) or ""
                            for f in dec.decode(tus[u])]
            finally:
                dec.close()
            record.stats += dec.stats
            wants = list(enumerate(ref["frames"]))
            record.add_paths(ref.get("paths"),
                             [st.get("recon_path") for st in dec.stats])
        else:
            raise ValueError(f"unknown entry {entry!r}")
        for k, (idx, want) in enumerate(wants):
            record.frames.append(Frame(call.stream, idx, want,
                                       got[k] if k < len(got) else None))
        # frames beyond what libaom shows are wrong answers too
        for g in got[len(wants):]:
            record.frames.append(Frame(call.stream, -1, "", g))
        record.calls.append(call)
