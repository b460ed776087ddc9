"""Public decoder API of the port: create / decode / drain.

Port of `av1dec_tpu.api` on a torch device:

    dec = Decoder(device="cuda")
    for _, tu in read_ivf(path):
        for frame in dec.decode(tu):
            frame.planes  # list of np arrays (Y, U, V)

Frames go to the device path when it takes them: intra frames and
translational inter frames (SIMPLE motion mode, unscaled references, one
reference list) through the MC pass, the wavefront scan and the
postfilter.  The other frames (OBMC, local or global warp, inter-intra,
scaled references, intra block copy) take the host pixel path,
`pipeline/recon.FrameRecon`: a NumPy walk over the blocks with the
residuals and CDEF on the same device.  Compound frames take the path
the reference picks for them: average and distance-weighted compound
the device path, wedge and difference-weighted compound the host path;
both blend as libaom does (the reference package's compound prediction
and the native parser it copies differ from libaom on compound
frames, ROADMAP queue 3; the port's copies are repaired).  Film grain
is added at output (`ops/spec/film_grain.py`).  The DPB keeps each
reference frame's planes on the host and, for a frame of the device
path, on the device (`dev_planes`); inter frames of the device path read
their references from the device copy, so such a frame never
round-trips to the host as a reference.  `Decoder.save_state` and
`load_state` checkpoint the decode at a temporal-unit boundary in a
NumPy `.npz` archive read without pickle.  `decode_stream_batched` is
the batched, pipelined decode of a whole all-intra stream (the JAX
package's `bench.py` `decode_stream_pipelined`).
"""
from __future__ import annotations

import hashlib
import io
import json
import zipfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from av1dec_tpu_torch import resolve_device, tracing
from av1dec_tpu_torch.bindings import NativeParser
from av1dec_tpu_torch.ops.kernels import deblock as _deblock
from av1dec_tpu_torch.ops.kernels import wavefront as _wavefront
from av1dec_tpu_torch.pipeline.device_recon import (DeviceRecon,
                                                    postfilter_batch,
                                                    prep_batch, scan_batch,
                                                    to_torch_inputs)
from av1dec_tpu_torch.pipeline.recon import run_host


def display_md5(planes, bit_depth, width, height, subsampling):
    """MD5 of a frame's planes cropped to the displayed size (luma
    height x width, chroma rounded up by the subsampling), as uint8
    (8-bit) or uint16 bytes — the MD5s of `testdata/manifest.json`."""
    h = hashlib.md5()
    dt = np.uint16 if bit_depth > 8 else np.uint8
    sx, sy = subsampling
    for i, p in enumerate(planes):
        ph = height if i == 0 else (height + sy) >> sy
        pw = width if i == 0 else (width + sx) >> sx
        h.update(np.ascontiguousarray(np.asarray(p)[:ph, :pw], dt)
                 .tobytes())
    return h.hexdigest()


@dataclass
class OutputFrame:
    planes: List[np.ndarray]
    bit_depth: int
    subsampling: tuple
    order_hint: int = 0
    frame_type: int = 0
    temporal_id: int = 0
    spatial_id: int = 0
    metadata: dict = field(default_factory=dict)  # HDR CLL/MDCV etc
    width: int = 0   # displayed luma width (upscaled)
    height: int = 0  # displayed luma height

    def md5(self) -> str:
        h = hashlib.md5()
        for p in self.planes:
            dt = np.uint16 if self.bit_depth > 8 else np.uint8
            h.update(np.ascontiguousarray(p.astype(dt)).tobytes())
        return h.hexdigest()

    def display_md5(self) -> str:
        return display_md5(self.planes, self.bit_depth, self.width,
                           self.height, self.subsampling)


# format version of Decoder.save_state blobs
STATE_VERSION = 1


@dataclass
class _Slot:
    planes: List[np.ndarray]
    width: int       # luma upscaled width
    height: int      # luma height
    frame_type: int
    grain: dict = field(default_factory=dict)
    bit_depth: int = 8
    subsampling: tuple = (1, 1)
    # device-resident copy of the reference planes, kept when the frame
    # took the device path and had no host filter tail
    dev_planes: Optional[list] = None


# the spans of an InterPlan: a stats record's `inter_plan_ms`
INTER_PLAN_SPANS = ("inter_plan", "inter_plan.refs", "inter_plan.lanes")


class Decoder:
    """AV1 decoder: temporal units in, display-order frames out.

    `config`: DecoderConfig (threads, operating point, grain, frame
    limits, `space_shards`: CDEF in that many column shards over the
    cards of the process, or on one device, with a warning, when there
    are fewer cards or the frame width does not split); None =
    defaults.  `device`: the torch device of the pixel path, "cuda" by
    default; the CPU runs only when named."""

    def __init__(self, config=None, device="cuda") -> None:
        from av1dec_tpu_torch.config import DecoderConfig
        self.config = config or DecoderConfig()
        self.device = resolve_device(device)
        self._parser = NativeParser(
            threads=self.config.threads,
            operating_point=self.config.operating_point)
        self._dpb: Dict[int, Optional[_Slot]] = {i: None for i in range(8)}
        self._shown = 0
        self.stats: List[dict] = []  # per-frame decode records
        # the tracing unit of the next coded frame: its parse (and an
        # earlier TU's that made no frame) is charged to it
        self._id = tracing.new_id()
        self._unit = tracing.Unit(self._id, 0)

    @property
    def seq(self):
        return self._parser.seq

    def decode(self, tu: bytes) -> List[OutputFrame]:
        """The frames the temporal unit `tu` shows, in order.  Each coded
        frame appends a record to `stats`: its header's facts, the recon
        path, `ms` (the frame's decode, host clock), `inter_plan_ms`,
        kernel launches, and from `tracing` its index `frame`, `spans_ms`
        (self ms by span), the copies to and from the card, the host
        path's `inter_blocks` by motion kind and the device path's
        `inter_lanes` (MC lane `rows`, sub-8x8 chroma `pieces`),
        `refs_bytes` (the reference samples packed for MC, in bytes) and
        `residual_blocks` (the blocks with a residual whose levels went
        to the device, `card`, or that took the NumPy route, `numpy`)."""
        out: List[OutputFrame] = []
        with tracing.unit(self._unit), tracing.span("parse"):
            frames = self._parser.parse_tu(tu, with_plans=True)
        for hdr, plans in frames:
            unit = self._unit
            seq = self._parser.seq
            if hdr.get("show_existing_frame"):
                slot = self._dpb[hdr["frame_to_show_map_idx"]]
                if slot is None:
                    raise ValueError("show_existing_frame: empty slot")
                with tracing.unit(unit):
                    out.append(self._emit(slot.planes, slot, hdr))
                if slot.frame_type == 0:  # KEY re-show refreshes all slots
                    for i in range(8):
                        self._dpb[i] = slot
                continue
            refs = None
            if not hdr.get("frame_is_intra", 1):
                refs = {}
                for rf in range(1, 8):
                    idx = hdr["ref_frame_idx"][rf - 1]
                    slot = self._dpb[idx]
                    if slot is not None:
                        refs[rf] = {"planes": slot.planes,
                                    "width": slot.width,
                                    "height": slot.height,
                                    "dev_planes": slot.dev_planes}
            with tracing.unit(unit):
                record, planes, slot = self._decode_frame(seq, hdr, plans,
                                                          refs, unit)
                if hdr.get("show_frame") or self.config.output_invisible:
                    out.append(self._emit(planes, slot, hdr))
            record["spans_ms"] = unit.spans_ms()
            record.update({k: unit.counts[k] for k in tracing.COPIES})
            record["inter_blocks"] = {k[len("blocks."):]: unit.counts[k]
                                      for k in tracing.BLOCKS}
            record["inter_lanes"] = {k[len("lanes."):]: unit.counts[k]
                                     for k in tracing.LANES}
            record["refs_bytes"] = unit.counts["refs.bytes"]
            record["residual_blocks"] = {
                k[len("residuals."):]: unit.counts[k]
                for k in tracing.RESIDUALS}
            self.stats.append(record)
            self._unit = tracing.Unit(self._id, unit.frame + 1)
        if self.config.max_frames:
            room = self.config.max_frames - self._shown
            out = out[:max(0, room)]
        self._shown += len(out)
        return out

    def _decode_frame(self, seq, hdr, plans, refs, unit):
        """One coded frame, on the device path or the host pixel path,
        into the DPB.  Returns (its stats record, its planes, its DPB
        slot)."""
        scans0 = _wavefront.launches
        dbl0 = _deblock.launches
        with tracing.span("decode"):
            dr = DeviceRecon(seq, hdr, plans, config=self.config,
                             refs=refs)
            dev_keep = host_reason = None
            if dr.supported():
                planes = dr.run(self.device)
                path = "device"
                # retain the device planes as a future ref unless a host
                # tail (SGR restoration, or host-side superres) changed
                # them
                if (not dr._needs_pre_cdef() or dr._lr_on_device) and \
                        (not hdr.get("use_superres") or dr._sr_on_device):
                    dev_keep = dr._final_dev
            else:
                host_reason = dr.unsupported_reason()
                planes = run_host(seq, hdr, plans, refs=refs,
                                  device=self.device)
                path = "host"
        ms = tracing.last_seconds() * 1000
        cdef = hdr.get("cdef") or {}
        record = {
            "frame": unit.frame,
            "frame_type": hdr["frame_type"],
            "show": int(bool(hdr.get("show_frame"))),
            "qindex": hdr["quant"]["base_q_idx"],
            "width": hdr["frame_width"],
            "height": hdr["frame_height"],
            "intra": int(bool(hdr.get("frame_is_intra", 1))),
            "cdef": int(bool(cdef.get("bits", 0) or
                             any(cdef.get("y_pri", [0])))),
            "superres": int(bool(hdr.get("use_superres"))),
            "lr": int(any((hdr.get("lr") or {})
                          .get("frame_restoration_type", [0, 0, 0]))),
            "recon_path": path,
            "host_reason": host_reason,
            "ms": round(ms, 2),
            "inter_plan_ms": round(unit.total(INTER_PLAN_SPANS) * 1000,
                                   2),
            # launches of the scan kernel (a card's device path: one
            # per frame) and the levels with lanes its counters
            # report complete
            "scan_launches": _wavefront.launches - scans0,
            "scan_levels": (_wavefront.levels_completed()
                            if _wavefront.launches > scans0 else 0),
            # launches of the deblock kernel (a card's device path:
            # one per frame with a loop-filter level)
            "deblock_launches": _deblock.launches - dbl0,
        }
        slot = _Slot(planes=planes,
                     width=hdr["upscaled_width"],
                     height=hdr["frame_height"],
                     frame_type=hdr["frame_type"],
                     grain=hdr.get("grain") or {},
                     bit_depth=seq["bit_depth"],
                     subsampling=(seq["subsampling_x"],
                                  seq["subsampling_y"]),
                     dev_planes=dev_keep)
        for i in range(8):
            if (hdr["refresh_frame_flags"] >> i) & 1:
                self._dpb[i] = slot
        return record, planes, slot

    @tracing.traced("emit")
    def _emit(self, planes, slot, hdr) -> OutputFrame:
        grain = slot.grain if hdr.get("show_existing_frame") \
            else (hdr.get("grain") or {})
        out_planes = planes
        if grain.get("apply_grain") and self.config.apply_grain:
            from av1dec_tpu_torch.ops.spec import film_grain
            out_planes = film_grain.apply_grain(
                planes, grain, slot.bit_depth, slot.subsampling[0],
                slot.subsampling[1])
        return OutputFrame(planes=out_planes, bit_depth=slot.bit_depth,
                           subsampling=slot.subsampling,
                           order_hint=hdr.get("order_hint", 0),
                           frame_type=slot.frame_type,
                           temporal_id=hdr.get("temporal_id", 0),
                           spatial_id=hdr.get("spatial_id", 0),
                           metadata=hdr.get("metadata") or {},
                           width=slot.width, height=slot.height)

    def save_state(self) -> bytes:
        """Checkpoint at a temporal-unit boundary: the native
        header-level state (sequence header, per-slot CDF contexts,
        segment maps, motion fields, order hints), the pixel DPB and the
        count of frames shown.  A fresh Decoder, on any device, that
        loads the blob resumes at the next temporal unit with output
        byte-identical to an uninterrupted decode.

        The blob is an `.npz` archive: `native` (the native state as
        uint8), `header` (JSON as uint8: format version, `shown`, each
        slot's frame index or null, and each distinct frame's geometry,
        grain parameters and plane dtypes) and each distinct frame's
        planes once, as `f<k>_p<plane>`, narrowed to uint8 or uint16 by
        bit depth.  Device copies of the references are not saved: the
        device path uploads host references when it needs them."""
        index, frames, slots = {}, [], []
        for i in range(8):
            slot = self._dpb[i]
            if slot is None:
                slots.append(None)
                continue
            if id(slot) not in index:
                index[id(slot)] = len(frames)
                frames.append(slot)
            slots.append(index[id(slot)])
        header = {"version": STATE_VERSION, "shown": self._shown,
                  "slots": slots, "frames": []}
        arrays = {"native": np.frombuffer(self._parser.save_state(),
                                          np.uint8)}
        for k, slot in enumerate(frames):
            planes = [np.asarray(p) for p in slot.planes]
            header["frames"].append({
                "width": slot.width, "height": slot.height,
                "frame_type": slot.frame_type, "grain": slot.grain,
                "bit_depth": slot.bit_depth,
                "subsampling": list(slot.subsampling),
                "dtypes": [p.dtype.str for p in planes]})
            narrow = np.uint16 if slot.bit_depth > 8 else np.uint8
            for pl, p in enumerate(planes):
                arrays[f"f{k}_p{pl}"] = p.astype(narrow)
        arrays["header"] = np.frombuffer(json.dumps(header).encode(),
                                         np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    def load_state(self, blob: bytes) -> None:
        """Restore a `save_state` blob.  Raises ValueError on anything
        else (garbage, a pickle, another format version, a missing
        entry); nothing in the blob is executed.  The decoder is left as
        it was unless the whole blob reads.  Every restored slot holds
        host planes only.  The native state's own sizes are trusted as
        the native library reads them."""
        try:
            with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                header = json.loads(z["header"].tobytes().decode())
                if header["version"] != STATE_VERSION:
                    raise ValueError(f"format version {header['version']}"
                                     f", this decoder reads "
                                     f"{STATE_VERSION}")
                frames = []
                for k, f in enumerate(header["frames"]):
                    planes = []
                    for pl, dt in enumerate(f["dtypes"]):
                        dt = np.dtype(dt)
                        if dt.kind not in "iu":
                            raise ValueError(f"plane dtype {dt}")
                        planes.append(z[f"f{k}_p{pl}"].astype(dt))
                    frames.append(_Slot(
                        planes=planes, width=int(f["width"]),
                        height=int(f["height"]),
                        frame_type=int(f["frame_type"]),
                        grain=dict(f["grain"]),
                        bit_depth=int(f["bit_depth"]),
                        subsampling=tuple(int(v)
                                          for v in f["subsampling"])))
                slots = header["slots"]
                if len(slots) != 8:
                    raise ValueError(f"{len(slots)} DPB slots")
                if any(k is not None and not 0 <= k < len(frames)
                       for k in slots):
                    raise ValueError(f"DPB slots {slots} name frames "
                                     f"beyond the {len(frames)} saved")
                dpb = {i: None if k is None else frames[k]
                       for i, k in enumerate(slots)}
                shown = int(header["shown"])
                native = z["native"].tobytes()
        except (ValueError, KeyError, TypeError, IndexError, EOFError,
                OSError, zipfile.BadZipFile) as e:
            raise ValueError(f"load_state: not a checkpoint of this "
                             f"decoder ({type(e).__name__}: {e})") from e
        self._parser.load_state(native)
        self._dpb = dpb
        self._shown = shown

    def close(self) -> None:
        self._parser.close()


def decode_file(path: str, config=None, device="cuda") -> List[OutputFrame]:
    """Decode a whole file (IVF, Annex-B, or raw OBU stream)."""
    from av1dec_tpu_torch.container import read_temporal_units

    frames: List[OutputFrame] = []
    dec = Decoder(config, device=device)
    limit = dec.config.max_frames
    for _, tu in read_temporal_units(path):
        frames += dec.decode(tu)
        if limit and len(frames) >= limit:
            break
    dec.close()
    return frames


def decode_ivf(path: str, config=None, device="cuda") -> List[OutputFrame]:
    """Alias for decode_file."""
    return decode_file(path, config, device)


STAGES = ("parse", "host_path", "host_prep", "scan", "postfilter", "fetch")
# the spans whose self times make each stage of `decode_stream_batched`
STAGE_SPANS = {
    "parse": ("parse", "schedule", "eligibility") + INTER_PLAN_SPANS,
    "host_path": ("host", "host.walk", "host.residuals", "host.filter",
                  "host.inter_pred"),
    "host_prep": ("prep", "prep.residuals", "prep.rows",
                  "prep.deblock_maps"),
    "scan": ("upload", "upload.plan", "upload.mc", "upload.residuals",
             "dispatch.scan"),
    "postfilter": ("dispatch", "dispatch.post_args"),
    "fetch": ("fetch", "fetch.copy", "fetch.widen", "fetch.tail"),
}


def _prep_in(unit, drs):
    """`prep_batch(drs)` with its spans in `unit` (on a worker thread)."""
    with tracing.unit(unit):
        return prep_batch(drs)


def decode_stream_batched(datas, device="cuda", batch=4, timings=None):
    """Decode the temporal units `datas` of an all-intra stream in
    batches of `batch` frames: frames are independent, so one wavefront
    scan serves the whole batch (level i of every frame at the same scan
    position).  An intra frame the device path refuses (intra block
    copy) is decoded inline, in frame order, on the host pixel path
    (`pipeline/recon.FrameRecon`, with its residuals and CDEF on
    `device`), as the JAX package's `bench.py` decode_stream_pipelined
    does.  An inter frame raises NotImplementedError: it depends on
    earlier frames of the batch (decode such streams with `Decoder`).
    The host prep of batch k+1 (residual itx, lane packing, deblock
    maps) runs on a worker thread while the device works on batch k.
    Returns per-frame host plane lists (int64), in frame order.

    Each batch is a `tracing.Unit` (the call's id, the batch's index),
    which also takes the parse of the temporal units that start while
    its frames are parsed, and the host pixel path's frames among them.
    `timings`: optional dict that receives the seconds of each stage of
    STAGES, its spans' self times (STAGE_SPANS) over the batches; the
    device is then synchronised after the scan (inside `dispatch.scan`)
    and after the postfilter (inside `dispatch`) of every batch so that
    each stage's time is its own (host prep is the worker's own time;
    `host_path` is the host pixel path's frames, out of `parse`)."""
    dev = resolve_device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda" and
            timings is not None else (lambda: None))
    call = tracing.new_id()
    units = []

    def unit_of(k):
        """The unit of the batch of device-path frame k."""
        while len(units) <= k // batch:
            units.append(tracing.Unit(call, len(units)))
        return units[k // batch]

    parser = NativeParser()
    drs = []
    slots = []  # frame order: ("dev", index in drs) or ("host", planes)
    for d in datas:
        with tracing.unit(unit_of(len(drs))):
            with tracing.span("parse"):
                frames = parser.parse_tu(d, with_plans=True)
            for hdr, plans in frames:
                if hdr.get("show_existing_frame"):
                    raise NotImplementedError(
                        "decode_stream_batched: show_existing_frame")
                if not hdr.get("frame_is_intra", 1):
                    raise NotImplementedError(
                        "decode_stream_batched decodes all-intra streams: "
                        "the frames of a batch are independent, and an "
                        "inter frame is not (decode it with Decoder)")
                dr = DeviceRecon(parser.seq, hdr, plans)
                if dr.supported():
                    slots.append(("dev", len(drs)))
                    drs.append(dr)
                else:
                    planes = run_host(parser.seq, hdr, plans, device=dev)
                    slots.append(("host", [np.asarray(p) for p in planes]))
    parser.close()

    chunks = [drs[i:i + batch] for i in range(0, len(drs), batch)]
    dev_out = []
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(_prep_in, unit_of(0), chunks[0]) if chunks else None
        for i, ch in enumerate(chunks):
            prep = fut.result()
            if i + 1 < len(chunks):
                fut = ex.submit(_prep_in, unit_of((i + 1) * batch),
                                chunks[i + 1])
            with tracing.unit(unit_of(i * batch)):
                inputs = to_torch_inputs(prep, dev)
                with tracing.span("dispatch"):
                    with tracing.span("dispatch.scan"):
                        frame = scan_batch(inputs)
                        sync()
                    dev_out += postfilter_batch(ch, inputs, frame)
                    sync()
    fetched = []
    for k, (dr, planes) in enumerate(zip(drs, dev_out)):
        with tracing.unit(unit_of(k)):
            fetched.append(dr.fetch(planes))
    out = [fetched[v] if kind == "dev" else v for kind, v in slots]
    if timings is not None:
        timings.update({k: sum(u.total(STAGE_SPANS[k]) for u in units)
                        for k in STAGES})
    return out
