"""Device frame reconstruction driver (torch).

Port of `av1dec_tpu.pipeline.device_recon` for intra frames and
translational inter frames: the host packs residuals (NumPy dequant +
inverse transform), wavefront lanes, palette tensors, deblock edge maps
and, for inter frames, the MC lanes and reference pieces of their
`InterPlan` (`prep_batch`); the device runs, per inter frame, the MC
pass (`ops/kernels/mc.mc_into`, predictions straight into the frame
buffer), then the batched wavefront scan (intra lanes and MF_INTER
residual lanes) and, per frame, the postfilter chain slice -> deblock
-> CDEF -> superres -> Wiener LR -> narrowing cast (`dispatch_batch`);
on a card, deblock, CDEF, superres and Wiener LR are hand-written
kernels (`ops/kernels/{deblock,cdef,superres,lr}.py`).
Frames with a self-guided restoration unit finish LR on the host after
the fetch (`finish_host`).

The lane rows, windows and buffer layouts are the JAX package's
(`BUCKETS`, `BWIN`, `FLAT_PAD`, `_DEV_FIELDS`), so both packages scan
identical inputs (`to_torch_inputs` uploads the JAX package's
`prep_batch` dict as well as this one's).  What the JAX package does
only to keep its jit keys stable is left out: power-of-two capacities
and batch padding (eager torch runs exact sizes), and the scan's CHUNK.
Inter frames that `device_inter.ineligible_reason` refuses (exotic
tools: OBMC, warp, inter-intra, wedge and difference-weighted compound,
scaled references) and intra block copy frames have no schedule here:
`api.Decoder` sends them to the host pixel path
(`pipeline/recon.FrameRecon`).  With `DecoderConfig.space_shards` > 1
CDEF runs in column shards over the devices of the process
(`_cdef_device`, `parallel/sharded_cdef.cdef_local`).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from av1dec_tpu_torch import resolve_device, tracing
from av1dec_tpu_torch.ops.kernels import cdef as cdef_dev
from av1dec_tpu_torch.ops.kernels.deblock import deblock_planes
from av1dec_tpu_torch.ops.kernels.lr import lr_wiener_planes
from av1dec_tpu_torch.ops.kernels.mc import mc_into
from av1dec_tpu_torch.ops.kernels.superres import superres_planes
from av1dec_tpu_torch.ops.kernels.wavefront import (_DEV_FIELDS,
                                                    plan_levels,
                                                    plan_windows, scan_into)
from av1dec_tpu_torch.ops.spec import itx
from av1dec_tpu_torch.pipeline import device_inter as di
from av1dec_tpu_torch.pipeline import wavefront as wf

TX_DIMS = itx.TX_DIMS
BUCKETS = (16, 32, 64)
BWIN = {16: 128, 32: 64, 64: 16}  # window lane caps
FLAT_PAD = 64  # tail pad so T-wide row windows never cross the end
_DEV_F = {name: i for i, name in enumerate(_DEV_FIELDS)}
_log = logging.getLogger("av1dec_tpu_torch")


def _bucket_for(w, h):
    m = max(w, h)
    return 16 if m <= 16 else 32 if m <= 32 else 64


def _postfilter_chain(frame, base, dbl_maps, gates, sr_args, lr_args, cfg):
    """Per-frame postfilter: plane slice -> deblock -> CDEF -> superres
    upscale -> Wiener LR -> narrow cast.  cfg: (plane_geom, bd, sharp,
    damping, subx_c, suby_c, has_dbl, has_cdef, has_sr, has_lr,
    need_pre), small ints.  Returns (final planes, pre-CDEF planes or
    ()); with superres both are upscaled (LR consumes both)."""
    (geom, bd, sharp, damping, subx_c, suby_c,
     has_dbl, has_cdef, has_sr, has_lr, need_pre) = cfg
    planes = []
    for (pb, ha, wa, vh, vw) in geom:
        flat = frame[base + pb: base + pb + ha * wa]
        planes.append(flat.reshape(ha, wa)[:vh, :vw])
    if has_dbl:
        planes = list(deblock_planes(tuple(planes), dbl_maps, sharp, bd))
    odt = torch.uint8 if bd == 8 else torch.uint16
    pre = list(planes) if need_pre else None
    if has_cdef:
        y_pri, y_sec, uv_pri, uv_sec = gates
        planes = list(cdef_dev.cdef_frame(
            tuple(planes), y_pri, y_sec, uv_pri, uv_sec, bd, damping,
            subx_c, suby_c))
    if has_sr:  # the final and the pre-CDEF planes in one call
        n = len(planes)
        up = superres_planes(planes + (pre or []),
                             tuple(sr_args) * (1 + (pre is not None)), bd)
        planes, pre = up[:n], (up[n:] if pre is not None else None)
    if has_lr:  # all-Wiener restoration on device [SPEC §7.17.4]
        planes = lr_wiener_planes(planes, pre, lr_args, bd)
        pre = None  # consumed: host tail has nothing left to do
    pre_out = tuple(p.to(odt) for p in pre) if pre is not None else ()
    return tuple(p.to(odt) for p in planes), pre_out


def _i32(a, device):
    return tracing.to_device(np.ascontiguousarray(a, np.int32), device)


class DeviceRecon:
    """Device executor for one frame; `run()` returns host planes.  Use
    `supported()` first: intra-block-copy frames, and inter frames
    without `refs` or with an inter tool the MC lanes do not express,
    have no schedule here.

    `refs`: for inter frames, {ref_frame (1..7): {"planes", "width",
    "height", "dev_planes"}} from the decoder's DPB, as in the JAX
    package; `dev_planes` (device tensors or None) are read in place of
    the host planes.

    With `config.space_shards` n > 1 and CDEF on, the postfilter runs
    unfused and CDEF runs in n column shards over the devices of this
    process (`_cdef_device`)."""

    def __init__(self, seq, hdr, plans, config=None, refs=None):
        self.config = config
        self.refs = refs
        self._pre_cdef_dev = None
        self._final_dev = None
        self._sr_on_device = False
        self._lr_on_device = False
        with tracing.span("schedule"):
            self.sch = wf.build_schedule(seq, hdr, plans,
                                         allow_inter=refs is not None)
        self.seq, self.hdr, self.plans = seq, hdr, plans
        self._inter_plan = None
        self._inter_reason = None
        if self.sch is not None and self.sch.has_inter:
            with tracing.span("eligibility"):
                self._inter_reason = di.ineligible_reason(
                    hdr, plans, refs, self.sch.num_planes)
            if self._inter_reason is None:
                with tracing.span("inter_plan"):
                    self._inter_plan = di.InterPlan(seq, hdr, plans, refs,
                                                    self.sch)
            else:
                self.sch = None  # exotic inter tools: not on this path
        if self.sch is not None:
            # deterministic per-(w, h) offsets: palette slots per bucket,
            # residual PIXEL offsets into the packed flat buffer
            self._pal_off = {}
            self._pal_tot = dict.fromkeys(BUCKETS, 0)
            self._res_px_base = {}
            self._res_px_tot = 0
            for key in sorted(self.sch.classes):
                t = _bucket_for(*key)
                self._res_px_base[key] = self._res_px_tot
                self._res_px_tot += self.sch.res_count.get(key, 0) * \
                    key[0] * key[1]
                self._pal_off[key] = self._pal_tot[t]
                self._pal_tot[t] += len(self.sch.pal_preds.get(key, []))

    def supported(self):
        return self.sch is not None

    def unsupported_reason(self):
        """Why the device path cannot take this frame (None if it can)."""
        if self.sch is not None:
            return None
        if self.plans is not None and self.plans.grid("intrabc").any():
            return "intra block copy frame"
        if self._inter_reason is not None:
            return self._inter_reason
        if self.plans is not None and self.plans.grid("is_inter").any():
            return "inter frame without reference frames"
        return "frame without transform blocks"

    def _needs_pre_cdef(self):
        """Loop restoration reads the pre-CDEF (post-deblock) pixels."""
        lr_types = (self.hdr.get("lr") or {}).get(
            "frame_restoration_type", [0, 0, 0])
        return any(lr_types)

    # -- residuals ---------------------------------------------------------
    def _residuals_flat_np(self):
        """Packed residual pixels, computed with the vectorized NumPy
        path (ops/spec itx lanes).  int16 for 8-bit (residuals fit
        [-32768, 32767] per the §7.13.3 clamps)."""
        res_np = wf.compute_residuals(self.sch)
        dt = np.int16 if self.sch.bd == 8 else np.int32
        buf = np.zeros(self._res_px_tot, dt)
        for key, tensor in res_np.items():
            if not len(tensor):
                continue
            b = self._res_px_base[key]
            flat = tensor.reshape(-1)
            if dt == np.int16:
                flat = np.clip(flat, -32768, 32767)
            buf[b: b + flat.size] = flat
        return buf

    # -- schedule packing --------------------------------------------------
    def _bucket_rows(self, t):
        """All of this frame's lanes for bucket t as (rows [N, F] int32,
        levels [N]) with bucket-global residual/palette slot indices."""
        sch = self.sch
        FD = len(_DEV_FIELDS)
        rows, lvls = [], []
        for key, bc in sorted(sch.classes.items()):
            w, h = key
            if _bucket_for(w, h) != t:
                continue
            N = len(bc.levels_sorted)
            arr = np.zeros((N, FD), np.int32)
            for f, a in bc.packed.items():
                arr[:, _DEV_F[f]] = a
            ridx = arr[:, _DEV_F["res_idx"]]
            arr[:, _DEV_F["res_idx"]] = np.where(
                ridx >= 0, self._res_px_base[key] + ridx * (w * h), -1)
            pidx = arr[:, _DEV_F["pal_idx"]]
            arr[:, _DEV_F["pal_idx"]] = np.where(
                pidx >= 0, pidx + self._pal_off[key], -1)
            arr[:, _DEV_F["w"]] = w
            arr[:, _DEV_F["h"]] = h
            arr[:, _DEV_F["lw"]] = int(np.log2(w))
            arr[:, _DEV_F["lh"]] = int(np.log2(h))
            rows.append(arr)
            lvls.append(bc.levels_sorted)
        if rows:
            return (np.concatenate(rows, axis=0),
                    np.concatenate(lvls).astype(np.int64))
        return np.zeros((0, FD), np.int32), np.zeros(0, np.int64)

    def _palette_tensor(self, t, P):
        sch = self.sch
        pt = np.zeros((P, t, t), np.int32)
        for key, preds in sch.pal_preds.items():
            if _bucket_for(*key) != t:
                continue
            off = self._pal_off[key]
            w, h = key
            for k, pr in enumerate(preds):
                pt[off + k, :h, :w] = pr
        return pt

    # -- postfilter --------------------------------------------------------
    def _post_device(self, frame, base, maps):
        """Postfilter of the frame at `base` within the flat buffer.
        Returns (final planes, pre-CDEF planes or None).  Its host half
        (gates, deblock maps, superres and Wiener arguments, built and
        uploaded) is the span `dispatch.post_args`."""
        sch = self.sch
        dev = frame.device
        with tracing.span("dispatch.post_args"):
            gates = cdef_dev.compute_gates(self.seq, self.hdr, self.plans,
                                           sch.num_planes, sch.bd)
            dbl_dev = ()
            sharp = 0
            if maps is not None:
                dbl_dev = tuple(
                    ((_i32(fv, dev), _i32(lv, dev)),
                     (_i32(fh, dev), _i32(lh, dev)))
                    for (fv, lv), (fh, lh) in maps)
                sharp = int(self.hdr["lf"]["sharpness"])
            sharded = gates is not None and \
                (getattr(self.config, "space_shards", 0) or 0) > 1
            if not sharded:
                args = self._chain_args(dev, gates, maps, sharp)
        if sharded:
            # column-sharded CDEF (unfused): slice -> deblock -> pre-CDEF
            # copy -> CDEF; superres and LR finish on the host
            # (finish_host), as in the JAX package
            odt = torch.uint8 if sch.bd == 8 else torch.uint16
            planes = []
            for p in range(sch.num_planes):
                (ha, wa), (vh, vw) = sch.alloc_dims[p], sch.valid_dims[p]
                b = base + sch.plane_base[p]
                planes.append(frame[b: b + ha * wa].reshape(ha, wa)
                              [:vh, :vw])
            if maps is not None:
                planes = list(deblock_planes(tuple(planes), dbl_dev, sharp,
                                             sch.bd))
            pre = [p.to(odt) for p in planes] \
                if self._needs_pre_cdef() else None
            planes = self._cdef_device(planes, gates)
            return [p.to(odt) for p in planes], pre
        final, pre = _postfilter_chain(frame, base, dbl_dev, *args)
        return list(final), (list(pre) if pre else None)

    def _chain_args(self, dev, gates, maps, sharp):
        """(gates, superres args, Wiener args, cfg) of
        `_postfilter_chain`, uploaded to `dev`."""
        sch = self.sch
        gates_dev = ()
        damping = 0
        subx_c = suby_c = 0
        if gates is not None:
            y_pri, y_sec, uv_pri, uv_sec, damping, subx_c, suby_c = gates
            gates_dev = tuple(_i32(g, dev)
                              for g in (y_pri, y_sec, uv_pri, uv_sec))
        geom = tuple(
            (sch.plane_base[p],) + tuple(sch.alloc_dims[p]) +
            tuple(sch.valid_dims[p]) for p in range(sch.num_planes))
        sr_dev = ()
        has_sr = bool(self.hdr.get("use_superres"))
        if has_sr:
            sr_dev = tuple((_i32(c, dev), _i32(t, dev))
                           for c, t in self._superres_args())
            self._sr_on_device = True
        lr_dev = ()
        lr_args = self._lr_wiener_args() if self._needs_pre_cdef() \
            else None
        has_lr = lr_args is not None
        if has_lr:
            lr_dev = tuple(
                None if a is None else
                tuple(_i32(x, dev) for x in a[:6]) +
                (tracing.to_device(a[6], dev),)
                for a in lr_args)
            self._lr_on_device = True
        cfg = (geom, sch.bd, sharp, int(damping), subx_c, suby_c,
               maps is not None, gates is not None, has_sr, has_lr,
               self._needs_pre_cdef())
        return gates_dev, sr_dev, lr_dev, cfg

    def _lr_wiener_args(self):
        """Host-built per-plane args for the device Wiener LR pass, or
        None when any active unit is self-guided (host LR tail) or LR
        is off.  Mirrors ops.spec.lr.lr_frame's unit/stripe geometry."""
        from av1dec_tpu_torch.ops.spec.lr import (RESTORE_NONE,
                                                  RESTORE_WIENER,
                                                  _count_units)
        hdr, sch, plans = self.hdr, self.sch, self.plans
        lr = hdr.get("lr") or {}
        frt = lr.get("frame_restoration_type", [0, 0, 0])
        if not any(frt):
            return None
        for rec in plans.lr:
            if int(rec[3]) not in (RESTORE_NONE, RESTORE_WIENER):
                return None  # SGR unit: host tail handles the frame
        units = {(int(r[0]), int(r[1]), int(r[2])): r for r in plans.lr}
        fw = hdr.get("upscaled_width", hdr["frame_width"])
        fh = hdr["frame_height"]
        out = []
        for plane in range(sch.num_planes):
            if frt[plane] == RESTORE_NONE:
                out.append(None)
                continue
            subx = sch.sub_x if plane else 0
            suby = sch.sub_y if plane else 0
            pw = (fw + subx) >> subx
            ph = (fh + suby) >> suby
            us = lr["loop_restoration_size"][plane]
            ucols = _count_units(us, pw)
            urows = _count_units(us, ph)
            H = sch.valid_dims[plane][0]
            W = ((hdr["upscaled_width"] + subx) >> subx) \
                if hdr.get("use_superres") else sch.valid_dims[plane][1]
            voff = 8 >> suby
            # unit index per pixel; sentinel row/col beyond the crop
            uy = np.full(H, urows, np.int32)
            for ur in range(urows):
                y0 = max(0, ur * us - voff)
                y1 = (ur + 1) * us - voff if ur + 1 < urows else ph
                uy[y0:min(y1, ph)] = ur
            ux = np.full(W, ucols, np.int32)
            for uc in range(ucols):
                x0 = uc * us
                x1 = (uc + 1) * us if uc + 1 < ucols else pw
                ux[x0:min(x1, pw)] = uc
            tv = np.zeros((urows + 1, ucols + 1, 7), np.int32)
            th = np.zeros((urows + 1, ucols + 1, 7), np.int32)
            act = np.zeros((urows + 1, ucols + 1), np.int32)
            for ur in range(urows):
                for uc in range(ucols):
                    rec = units.get((plane, ur, uc))
                    if rec is None or int(rec[3]) != RESTORE_WIENER:
                        continue
                    t_v = [int(rec[4]), int(rec[5]), int(rec[6])]
                    t_h = [int(rec[7]), int(rec[8]), int(rec[9])]
                    if plane:
                        t_v[0] = 0
                        t_h[0] = 0
                    tv[ur, uc] = [t_v[0], t_v[1], t_v[2],
                                  128 - 2 * sum(t_v), t_v[2], t_v[1],
                                  t_v[0]]
                    th[ur, uc] = [t_h[0], t_h[1], t_h[2],
                                  128 - 2 * sum(t_h), t_h[2], t_h[1],
                                  t_h[0]]
                    act[ur, uc] = 1
            # stripe-clamped vertical-tap source rows [SPEC §7.17.2]
            y = np.arange(H)
            yl = y << suby
            stripe = (yl + 8) // 64
            slo = (stripe * 64 - 8) >> suby
            shi = ((stripe + 1) * 64 - 8 >> suby) - 1
            vr = np.zeros((7, H), np.int32)
            inside = np.zeros((7, H), bool)
            for k in range(7):
                orig = y + k - 3
                ys = np.clip(np.clip(orig, slo - 2, shi + 2), 0, H - 1)
                vr[k] = ys
                inside[k] = ((orig >= slo) & (orig <= shi)) | \
                    ((ys >= slo) & (ys <= shi))
            out.append((uy, ux, tv, th, act, vr, inside))
        return out

    def _superres_args(self):
        """Per-plane (cols [dw, 8] int32, taps [dw, 8] int32) for the
        device superres gather; mirrors
        ops.spec.superres.upscale_plane_rows' index/phase math."""
        from av1dec_tpu_torch.ops.spec import superres as S
        hdr, sch = self.hdr, self.sch
        fw, uw = hdr["frame_width"], hdr["upscaled_width"]
        out = []
        for p in range(sch.num_planes):
            subx = sch.sub_x if p else 0
            sw = (fw + subx) >> subx
            dw = (uw + subx) >> subx
            vw = sch.valid_dims[p][1]
            step = ((sw << S.SCALE_BITS) + (dw >> 1)) // dw
            err = step * dw - (sw << S.SCALE_BITS)
            num = -((dw - sw) << (S.SCALE_BITS - 1)) + (dw >> 1)
            x0 = -((-num) // dw) if num < 0 else num // dw
            e2 = err // 2 if err >= 0 else -((-err) // 2)
            x0 += (1 << (S.EXTRA_BITS - 1)) - e2
            xs = x0 + step * np.arange(dw)
            px = xs >> S.SCALE_BITS
            subpel = (xs & S.SCALE_MASK) >> S.EXTRA_BITS
            cols = np.clip(px[:, None] + np.arange(8)[None, :] - 3,
                           0, vw - 1).astype(np.int32)
            taps = np.asarray(S.FILTER, np.int32)[subpel]
            out.append((cols, taps))
        return out

    def _cdef_device(self, planes, gates):
        """CDEF of the deblocked planes in `config.space_shards` column
        shards (`parallel.sharded_cdef.cdef_local`) over
        `sharded_cdef.local_devices`.  A width that is not
        a multiple of 8 * shards, or fewer devices than shards, falls
        back to one device (`cdef_frame`) with a warning on the
        `av1dec_tpu_torch` logger."""
        from av1dec_tpu_torch.parallel import sharded_cdef
        n = self.config.space_shards
        dev = planes[0].device
        devices = sharded_cdef.local_devices(dev)
        width = planes[0].shape[1]
        if width % (8 * n):
            _log.warning("sharded CDEF: width %d not divisible by 8*%d "
                         "shards; falling back to single-device", width, n)
        elif len(devices) < n:
            _log.warning("sharded CDEF: %d device(s) for %d shards; "
                         "falling back to single-device", len(devices), n)
        else:
            return list(sharded_cdef.cdef_local(planes, gates, self.sch.bd,
                                                devices[:n]))
        y_pri, y_sec, uv_pri, uv_sec, damping, subx, suby = gates
        return list(cdef_dev.cdef_frame(
            tuple(planes), *(_i32(g, dev) for g in (y_pri, y_sec, uv_pri,
                                                     uv_sec)),
            self.sch.bd, damping, subx, suby))

    def run(self, device="cuda"):
        """Full frame on `device` (a card unless "cpu" is named); returns
        host planes (int64).  Superres and LR that the device did not
        take finish on the host."""
        inputs = to_torch_inputs(prep_batch([self]), resolve_device(device))
        final = dispatch_batch([self], inputs)[0]
        return self.fetch(final)

    @tracing.traced("fetch")
    def fetch(self, final):
        """Device planes -> host int64 planes, with the host tail."""
        with tracing.span("fetch.copy"):
            out = [tracing.to_host(p).numpy().astype(np.int64)
                   for p in final]
            pre = None
            if self._pre_cdef_dev is not None:
                pre = [tracing.to_host(p).numpy().astype(np.int64)
                       for p in self._pre_cdef_dev]
        with tracing.span("fetch.tail"):
            return self.finish_host(out, pre)

    def finish_host(self, planes, pre_cdef):
        """Host tail of the filter chain: superres upscale + loop
        restoration [SPEC §7.16, §7.17] on fetched planes (no-op for
        the common case)."""
        hdr, seq, bd = self.hdr, self.seq, self.sch.bd
        if hdr.get("use_superres") and not self._sr_on_device:
            from av1dec_tpu_torch.ops.spec import superres
            planes = superres.superres_frame(planes, seq, hdr, bd)
            if pre_cdef is not None:
                pre_cdef = superres.superres_frame(pre_cdef, seq, hdr,
                                                   bd)
        if self._needs_pre_cdef() and not self._lr_on_device:
            from av1dec_tpu_torch.ops.spec import lr
            lr.lr_frame(planes, pre_cdef, seq, hdr, self.plans, bd)
        return planes


@tracing.traced("prep")
def prep_batch(drs):
    """Host-side half of the batched device decode: residual packing,
    lane assembly, palette tensors, deblock edge maps and the inter
    frames' MC lanes and reference pieces ("mc": [(frame index, lanes,
    pieces)]), with no device work.  Frames share one flat buffer at a
    per-frame stride; `decode_stream_batched` runs this on a worker
    thread so it overlaps the device work of the previous batch."""
    K = len(drs)
    sch0 = drs[0].sch
    flat = sch0.flat_len + FLAT_PAD
    Pcap = {t: max(1, max(dr._pal_tot[t] for dr in drs)) for t in BUCKETS}

    # packed residuals at a uniform per-frame stride (threaded: the
    # itx lanes are large numpy ops that release the GIL)
    with tracing.span("prep.residuals"):
        with ThreadPoolExecutor(2) as ex:
            bufs = list(ex.map(lambda dr: dr._residuals_flat_np(), drs))
        rf = max(1, max(len(b) for b in bufs))
        res_np = np.zeros(K * rf, bufs[0].dtype)
        for f, b in enumerate(bufs):
            res_np[f * rf: f * rf + len(b)] = b

    with tracing.span("prep.rows"):
        pal_np = {t: np.concatenate(
            [dr._palette_tensor(t, Pcap[t]) for dr in drs], axis=0)
            for t in BUCKETS}
        L = max(dr.sch.n_levels for dr in drs)
        buckets = []
        inputs_np = {}
        for t in BUCKETS:
            rows_all, lv_all = [], []
            for f, dr in enumerate(drs):
                arr, lv = dr._bucket_rows(t)
                arr = arr.copy()
                arr[:, _DEV_F["base"]] += f * flat
                arr[:, _DEV_F["lbase"]] += f * flat
                ridx = arr[:, _DEV_F["res_idx"]]
                arr[:, _DEV_F["res_idx"]] = np.where(
                    ridx >= 0, ridx + f * rf, -1)
                pidx = arr[:, _DEV_F["pal_idx"]]
                arr[:, _DEV_F["pal_idx"]] = np.where(
                    pidx >= 0, pidx + f * Pcap[t], -1)
                rows_all.append(arr)
                lv_all.append(lv)
            arr = np.concatenate(rows_all, axis=0)
            lv = np.concatenate(lv_all)
            order = np.argsort(lv, kind="stable")
            arr, lv = arr[order], lv[order]
            starts = np.zeros(L, np.int32)
            counts = np.zeros(L, np.int32)
            if len(lv):
                uniq, s_idx, cnt = np.unique(lv, return_index=True,
                                             return_counts=True)
                starts[uniq - 1] = s_idx
                counts[uniq - 1] = cnt
            buckets.append((t, BWIN[t]))
            inputs_np[t] = (arr, starts, counts)

    from av1dec_tpu_torch.ops.spec.deblock import build_deblock_maps
    with tracing.span("prep.deblock_maps"):
        dbl = [build_deblock_maps(dr.seq, dr.hdr, dr.plans,
                                  dr.sch.num_planes) for dr in drs]
    mc = [(f, dr._inter_plan.lanes, dr._inter_plan.ref_np)
          for f, dr in enumerate(drs) if dr._inter_plan is not None]
    return {
        "K": K, "flat": flat,
        "res_np": res_np, "pal_np": pal_np, "inputs_np": inputs_np,
        "buckets": tuple(buckets), "dbl": dbl, "mc": mc,
        "config": (tuple(buckets), sch0.bd, sch0.sub_x, sch0.sub_y,
                   sch0.enable_edge_filter),
    }


@tracing.traced("upload")
def to_torch_inputs(prep, device):
    """Upload a `prep_batch` dict (this package's or the JAX package's:
    the keys and layouts are the same; "mc" entries may hold either
    package's InterPlan lanes) to `device`, and plan the scan: the
    plain version's windows and their host flags, and the kernel's
    per-level lane ranges and ticket table (`plan_levels`; the tickets
    uploaded once, the rest kept on the host, so the launch reads no
    device value).  Reference
    pieces already on `device` are not copied.  Returns the dict
    `dispatch_batch` and `scan_batch` take."""
    dev = torch.device(device)
    ts = [t for t, _ in prep["buckets"]]
    inputs = prep["inputs_np"]
    with tracing.span("upload.plan"):
        windows = plan_windows({t: inputs[t][0] for t in ts},
                               {t: inputs[t][1] for t in ts},
                               {t: inputs[t][2] for t in ts},
                               prep["buckets"])
        table, level_lanes, tickets = plan_levels(
            {t: inputs[t][1] for t in ts}, {t: inputs[t][2] for t in ts},
            ts)
    bd = prep["config"][1]
    mc = []
    with tracing.span("upload.mc"):
        for f, lanes, pieces in prep.get("mc", ()):
            cfg, rows = di.upload_lanes(lanes, bd, dev, f * prep["flat"])
            mc.append((di.pack_ref_flat(pieces, dev), rows, cfg))
    return {
        "n": prep["K"] * prep["flat"], "flat": prep["flat"],
        "res": tracing.to_device(prep["res_np"], dev),
        "pal": {t: _i32(a, dev) for t, a in prep["pal_np"].items()},
        "packed": {t: _i32(inputs[t][0], dev) for t in ts},
        "windows": windows,
        "levels": (table, level_lanes, tickets, _i32(tickets, dev)),
        "config": tuple(prep["config"]),
        "dbl": prep["dbl"],
        "mc": mc,
        "device": dev,
    }


def scan_batch(inputs):
    """The MC pass of every inter frame (at its offset in the flat
    buffer), then the batched wavefront scan, both in place on one
    buffer with its trash slot: flat int32 frame buffer on the
    device."""
    n = inputs["n"]
    frame = torch.zeros(n + 1, dtype=torch.int32, device=inputs["device"])
    for ref_flat, lanes, cfg in inputs["mc"]:
        mc_into(frame, ref_flat, lanes, cfg)
    scan_into(frame, inputs["packed"], inputs["res"], inputs["pal"],
              inputs["config"], inputs["windows"], inputs["levels"])
    return frame[:n]


def postfilter_batch(drs, inputs, frame):
    """Per-frame postfilter of a scanned batch.  Returns a list (per
    frame) of device plane lists; each frame's pre-CDEF planes go to
    `dr._pre_cdef_dev` when its host LR tail needs them."""
    outs = []
    for f, dr in enumerate(drs):
        final, pre = dr._post_device(frame, f * inputs["flat"],
                                     inputs["dbl"][f])
        dr._pre_cdef_dev = pre
        dr._final_dev = final
        outs.append(final)
    return outs


def dispatch_batch(drs, inputs):
    """Device half: the batched wavefront scan + per-frame postfilter.
    `inputs` from `to_torch_inputs`.  Returns a list (per frame) of
    device plane lists (asynchronous).  Span `dispatch`, the scan's
    launches `dispatch.scan`."""
    with tracing.span("dispatch"):
        with tracing.span("dispatch.scan"):
            frame = scan_batch(inputs)
        return postfilter_batch(drs, inputs, frame)
