"""Container demux: IVF and Annex-B (length-delimited) byte sources.

IVF: 32-byte file header + 12-byte per-frame headers (de-facto format).
Annex B [SPEC Annex B]: leb128 temporal_unit_size > frame_unit_size >
obu_length framing, OBUs usually carried with obu_has_size_field == 0.
The decoder core consumes low-overhead temporal units (OBUs with size
fields), so Annex-B OBUs are re-wrapped: the has_size bit is set in the
header and a leb128 payload size inserted.

GOP-parallel decode (`decode_gops_parallel`): keyframe-delimited GOPs
decode in worker processes on the caller's device, and a dead worker's
GOPs are decoded again by a fresh pool.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import struct
import tempfile
from concurrent.futures import FIRST_EXCEPTION, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from typing import Iterator, List, Tuple


def leb128_read(buf: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    for i in range(8):
        if pos >= len(buf):
            raise ValueError("truncated stream: leb128 past end of buffer")
        b = buf[pos]
        v |= (b & 0x7F) << (7 * i)
        pos += 1
        if not (b & 0x80):
            break
    return v, pos


def leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_ivf(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield (pts, temporal_unit) from an IVF file."""
    with open(path, "rb") as f:
        head = f.read(32)
        if head[:4] != b"DKIF":
            raise ValueError("not an IVF file")
        while True:
            fh = f.read(12)
            if len(fh) < 12:
                return
            size, pts = struct.unpack("<IQ", fh)
            data = f.read(size)
            if len(data) < size:
                return
            yield pts, data


def _rewrap_obu(obu: bytes) -> bytes:
    """OBU (no size field) -> OBU with size field set."""
    if not obu:
        return obu
    b0 = obu[0]
    ext = (b0 >> 2) & 1
    hlen = 1 + ext
    if (b0 >> 1) & 1:  # already has a size field
        return obu
    payload = obu[hlen:]
    return bytes([b0 | 0x02]) + obu[1:hlen] + leb128(len(payload)) + payload


def _strip_obu_size(obu_stream: bytes) -> List[bytes]:
    """Split a low-overhead OBU stream into sizeless OBUs (for writing
    Annex-B)."""
    out = []
    pos = 0
    n = len(obu_stream)
    while pos < n:
        b0 = obu_stream[pos]
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        hdr_end = pos + 1 + ext
        if has_size:
            size, p2 = leb128_read(obu_stream, hdr_end)
            body = obu_stream[p2: p2 + size]
            out.append(bytes([b0 & ~0x02]) + obu_stream[pos + 1: hdr_end]
                       + body)
            pos = p2 + size
        else:
            out.append(obu_stream[pos:])
            pos = n
    return out


def read_annexb(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield (index, temporal_unit-as-low-overhead-OBUs) from an
    Annex-B file [SPEC Annex B].  Raises ValueError on truncated
    framing (fault-tolerance tier: file-level demux fails as cleanly
    as TU-level decode)."""
    data = open(path, "rb").read()
    pos = 0
    idx = 0
    while pos < len(data):
        tu_size, pos = leb128_read(data, pos)
        tu_end = pos + tu_size
        if tu_end > len(data):
            raise ValueError("truncated stream: temporal unit framing")
        out = bytearray()
        while pos < tu_end:
            fu_size, pos = leb128_read(data, pos)
            fu_end = pos + fu_size
            if fu_end > tu_end:
                raise ValueError("truncated stream: frame unit framing")
            while pos < fu_end:
                obu_len, pos = leb128_read(data, pos)
                if pos + obu_len > fu_end:
                    raise ValueError("truncated stream: OBU framing")
                out += _rewrap_obu(data[pos: pos + obu_len])
                pos += obu_len
            pos = fu_end
        pos = tu_end
        yield idx, bytes(out)
        idx += 1


def write_annexb(path: str, tus: List[bytes]) -> None:
    """Write temporal units (low-overhead OBU streams) as Annex B.
    Each TU becomes one frame unit holding its sizeless OBUs."""
    with open(path, "wb") as f:
        for tu in tus:
            obus = [bytes(o) for o in _strip_obu_size(tu)
                    if (o[0] >> 3) & 0xF != 2]  # drop temporal delimiters
            fu = b"".join(leb128(len(o)) + o for o in obus)
            fu_block = leb128(len(fu)) + fu
            f.write(leb128(len(fu_block)) + fu_block)


def _walks_as_obu_stream(data: bytes) -> bool:
    """True if `data` parses as a chain of low-overhead OBUs covering
    the buffer exactly (the probe for raw OBU files): each OBU carries
    its size, except that the last one may leave it out and run to the
    end of the buffer, as the spec allows [SPEC §5.3.1].  The first OBU
    must carry a size (an Annex B length byte can read as a sizeless
    OBU header)."""
    pos, n = 0, len(data)
    seen = 0
    while pos < n:
        b0 = data[pos]
        if b0 >> 7:          # forbidden bit
            return False
        typ = (b0 >> 3) & 0xF
        if typ == 0 or (9 <= typ <= 14):   # reserved types
            return False
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        if not has_size:     # the last OBU: its payload runs to the end
            return seen > 0 and pos + 1 + ext <= n
        try:
            size, body = leb128_read(data, pos + 1 + ext)
        except ValueError:
            return False
        if body + size > n:
            return False
        pos = body + size
        seen += 1
    return seen > 0


def detect_format(path: str) -> str:
    """'ivf' | 'annexb' | 'obu' (raw low-overhead stream).

    A small leading leb128 in an Annex-B file can also parse as an OBU
    header byte, so the OBU probe verifies the whole buffer chains as
    size-bearing OBUs to EOF before classifying as 'obu'."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"DKIF":
        return "ivf"
    if data and (data[0] >> 7) == 0 and ((data[0] >> 3) & 0xF) in (1, 2) \
            and _walks_as_obu_stream(data):
        return "obu"
    return "annexb"


def read_temporal_units(path: str) -> Iterator[Tuple[int, bytes]]:
    """Demux any supported container into temporal units."""
    fmt = detect_format(path)
    if fmt == "ivf":
        yield from read_ivf(path)
    elif fmt == "annexb":
        yield from read_annexb(path)
    else:
        yield 0, open(path, "rb").read()


def index_keyframes(path: str) -> List[int]:
    """Stream indexer [SURVEY §2.4 GOP sharding]: temporal-unit indices
    that start a new keyframe-delimited GOP.

    Peeks each TU's first frame-header OBU: a shown KEY frame starts
    with show_existing_frame=0, frame_type=KEY (bits 0,00) in the
    uncompressed header [SPEC §5.9.2].  (Streams with
    reduced_still_picture_header are all-keyframe by construction.)
    """
    idx = []
    for i, (_, tu) in enumerate(read_temporal_units(path)):
        pos = 0
        is_key = False
        while pos < len(tu):
            b0 = tu[pos]
            typ = (b0 >> 3) & 0xF
            ext = (b0 >> 2) & 1
            has_size = (b0 >> 1) & 1
            hdr_end = pos + 1 + ext
            if has_size:
                size, body = leb128_read(tu, hdr_end)
            else:
                size, body = len(tu) - hdr_end, hdr_end
            # FRAME_HEADER (3) / FRAME (6) only — a repeated SEQUENCE
            # HEADER (1) would false-positive as a key frame.  Require
            # the show_frame bit too: a forward keyframe (KEY with
            # show_frame=0) is re-shown later via show_existing_frame
            # and is NOT a safe split point.
            if typ in (3, 6) and size > 0 and body < len(tu):
                first = tu[body]
                show_existing = first >> 7
                frame_type = (first >> 5) & 3
                show_frame = (first >> 4) & 1
                is_key = (show_existing == 0 and frame_type == 0 and
                          show_frame == 1)
                break
            pos = body + size
        if is_key or i == 0:
            idx.append(i)
    return idx


def _decode_gop(args):
    """Decode temporal units [start, end) of `path` with a fresh Decoder
    on `device`.  Returns (frames as (planes, bit_depth, subsampling,
    order_hint, frame_type, width, height), the Decoder's stats, the
    process id)."""
    path, start, end, cfg_kw, device = args
    # fault-injection hook of the elastic-recovery test: a worker process
    # assigned this GOP dies hard (os._exit), once per parent process
    kill = os.environ.get("AV1DEC_TEST_KILL_GOP")
    if kill is not None and int(kill) == start and \
            multiprocessing.current_process().name != "MainProcess":
        marker = os.path.join(tempfile.gettempdir(),
                              f"av1dec_killed_gop_{start}_{os.getppid()}")
        if not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    dec = Decoder(DecoderConfig(**cfg_kw), device=device)
    out = []
    try:
        for i, (_, tu) in enumerate(read_temporal_units(path)):
            if i < start:
                continue
            if i >= end:
                break
            for fr in dec.decode(tu):
                out.append((fr.planes, fr.bit_depth, fr.subsampling,
                            fr.order_hint, fr.frame_type, fr.width,
                            fr.height))
    finally:
        dec.close()
    return out, dec.stats, os.getpid()


# worker pools a GOP whose worker died is given, before the calling
# process decodes it itself
POOL_ATTEMPTS = 3


def _run_jobs_elastic(jobs, workers):
    """Run GOP jobs in `spawn` worker processes (CUDA cannot be forked)
    with elastic recovery: GOPs are independent, so the GOPs of a worker
    that died (BrokenProcessPool) go to a fresh pool, and after
    POOL_ATTEMPTS pools to the calling process.  An error raised by the
    decode inside a worker is the stream's, not the worker's: it
    propagates at once, unretried.  Returns the results in job order."""
    results = {}
    remaining = list(enumerate(jobs))
    ctx = multiprocessing.get_context("spawn")
    for _ in range(POOL_ATTEMPTS):
        if not remaining:
            break
        try:
            with ProcessPoolExecutor(
                    max_workers=min(workers, len(remaining)),
                    mp_context=ctx) as ex:
                futs = {ex.submit(_decode_gop, j): i for i, j in remaining}
                pending = set(futs)
                while pending:
                    done, pending = wait(pending,
                                         return_when=FIRST_EXCEPTION)
                    for fut in done:
                        try:
                            results[futs[fut]] = fut.result()
                        except BrokenProcessPool:
                            pass  # the worker died: the GOP stays
                        except BaseException:
                            for f in pending:
                                f.cancel()
                            raise
        except BrokenProcessPool:
            pass  # the pool broke while the GOPs were submitted
        remaining = [(i, j) for i, j in remaining if i not in results]
    for i, j in remaining:  # last resort: decode in this process
        results[i] = _decode_gop(j)
    return [results[i] for i in range(len(jobs))]


def _gop_jobs(path, config, device):
    """(jobs, max_frames): a `_decode_gop` job per keyframe-delimited GOP
    of `path`, in stream order, decoding with `config` on `device`; and
    the config's whole-stream frame limit, which the jobs leave out (the
    caller applies it once, to the merged frames)."""
    from av1dec_tpu_torch.config import DecoderConfig
    keys = index_keyframes(path)
    bounds = keys + [sum(1 for _ in read_temporal_units(path))]
    cfg_kw = dataclasses.asdict(config or DecoderConfig())
    max_frames = cfg_kw.pop("max_frames", 0) or 0
    return ([(path, s, e, cfg_kw, device)
             for s, e in zip(bounds, bounds[1:])], max_frames)


def decode_gops_parallel(path: str, workers: int = 2, config=None,
                         device="cuda", stats=None):
    """GOP-parallel decode: keyframe-delimited GOPs are independent
    [SPEC §7.20 KEY refresh], so they decode at once in `workers` worker
    processes, each with its own Decoder on `device` (a card unless
    "cpu" is named).  Returns the frames in stream order (OutputFrame).

    `stats`: optional list that receives, per GOP in stream order,
    `{"gop": first temporal unit, "pid": worker process id, "frames":
    the worker Decoder's stats}`."""
    from av1dec_tpu_torch import resolve_device
    from av1dec_tpu_torch.api import OutputFrame

    jobs, max_frames = _gop_jobs(path, config, str(resolve_device(device)))
    if workers <= 1 or len(jobs) <= 1:
        chunks = [_decode_gop(j) for j in jobs]
    else:
        chunks = _run_jobs_elastic(jobs, workers)
    out = []
    for (_, start, _, _, _), (frames, gop_stats, pid) in zip(jobs, chunks):
        if stats is not None:
            stats.append({"gop": start, "pid": pid, "frames": gop_stats})
        for planes, bd, ss, oh, ft, w, h in frames:
            out.append(OutputFrame(planes=planes, bit_depth=bd,
                                   subsampling=ss, order_hint=oh,
                                   frame_type=ft, width=w, height=h))
    if max_frames:
        out = out[:max_frames]
    return out
