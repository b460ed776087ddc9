"""Device motion compensation: batched translational MC lanes, eager
torch. [SPEC §7.11.3.4]

Port of `av1dec_tpu.ops.kernels.mc` for the UNSCALED-reference case
(x_scale == y_scale == 1 << 14; frames with scaled references are not
on the device path):

- every prediction unit (block plane region, or sub-8x8 chroma piece)
  is a LANE with per-lane data: destination window, reference-buffer
  base/stride/clamp, integer tap origin, and the 8-tap filter row
  (bank*16 + subpel fraction) per axis, all precomputed on the host from
  the plan grids (`pipeline/device_inter.py`);
- lanes are bucketed by (tile size T, compound?); per bucket: one
  [N, T+7, T+7] window gather from the packed reference buffer, clamped
  to the reference's last row and column, then the horizontal and the
  vertical 8-tap pass as 8 shifted slices x per-lane taps, with the
  spec's rounding r0/r1;
- compound lanes carry BOTH lists and blend in-lane with per-lane
  weights and shift (average and distance-weighted compound share one
  w0*p0 + w1*p1 >> shift form [SPEC §7.11.3.15]);
- one scatter into the flat frame buffer per bucket.

`mc_into` is the whole pass of a frame.  A CUDA frame buffer runs the
hand-written kernel `csrc/mc.cu`, one launch for every bucket (counted
in `launches`; the grid is built on the host from `config`, so no device
value is read); a CPU buffer runs the plain version `_mc_plain`, the
bucket loop over `_mc_bucket`; nothing else is accepted.

What differs from the JAX version, because torch runs eagerly: a
bucket holds exactly its lanes (no power-of-two padding); JAX's scatter
`mode="drop"` becomes a write to a trash slot one past the end of the
frame buffer (the kernel writes only the kept pixels); the whole pass
runs under the scan's no-sync guard, so on a card it only enqueues work.
All math is int32, bit-exact with the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1dec_tpu_torch import tracing
from av1dec_tpu_torch.ops import inter_tables as T_
from av1dec_tpu_torch.ops.kernels.cuda_build import (launch, no_device_sync,
                                                     param_list, param_names)

# lane schedule fields (host packs [N, len(MC_FIELDS)] int32 rows)
MC_FIELDS = [
    "x", "y", "base", "stride", "w", "h",
    "rb0", "rs0", "lx0", "ly0", "cx0", "cy0", "hf0", "vf0",
    "rb1", "rs1", "lx1", "ly1", "cx1", "cy1", "hf1", "vf1",
    "w0", "w1", "bshift",
]
_MF = {name: i for i, name in enumerate(MC_FIELDS)}

# launches of the CUDA MC kernel in this process (one per pass with lanes)
launches = 0
# the kernel's int64 parameter array (`csrc/mc.cu`, enum Param): pointers,
# then ints, then per bucket its lane rows, T, compound flag and lanes
MAX_BUCKETS = 12
_PARAMS = param_names(["frame", "ref", "ftab", "ref_len", "ref_bytes", "bd",
                       "nb"], ("rows", "t", "comp", "n"), MAX_BUCKETS)

# all six filter banks as one [6*16, 8] table; lane hf/vf index rows
_FTAB = np.asarray(T_.SUBPEL_FILTERS, np.int32).reshape(-1, 8)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def _mc_list(ref_flat, sv, which, T, r0, ftab, ar):
    """Vertical-tap sums (unshifted) for one reference list: [N, T, T].
    Window gather + separable 8-tap with spec horizontal rounding."""
    s = "01"[which]
    rb = sv["rb" + s]
    rs = sv["rs" + s]
    lx = sv["lx" + s]
    ly = sv["ly" + s]
    cx = sv["cx" + s]
    cy = sv["cy" + s]
    fh = ftab[sv["hf" + s].long()]                             # [N, 8]
    fv = ftab[sv["vf" + s].long()]
    W = T + 7
    ri = ar[:W]
    rows = torch.minimum((cy[:, None] + ri).clamp(min=0), ly[:, None])
    cols = torch.minimum((cx[:, None] + ri).clamp(min=0), lx[:, None])
    idx = (rb[:, None, None] + rows[:, :, None] * rs[:, None, None] +
           cols[:, None, :])
    src = ref_flat[idx.clamp(0, ref_flat.shape[0] - 1).long()] \
        .to(torch.int32)                                       # [N, W, W]
    acc = torch.zeros_like(src[:, :, :T])
    for k in range(8):
        acc = acc + src[:, :, k:k + T] * fh[:, k][:, None, None]
    interm = _round2(acc, r0)                                  # [N, W, T]
    acc2 = torch.zeros_like(interm[:, :T, :])
    for k in range(8):
        acc2 = acc2 + interm[:, k:k + T, :] * fv[:, k][:, None, None]
    return acc2                                # unshifted vertical sums


def _mc_bucket(frame, n, ref_flat, rows, T, comp, bd, ftab, ar):
    """Predict all lanes of one (T, comp) bucket and scatter them into
    `frame` in place (masked pixels -> trash slot n)."""
    sv = {f: rows[:, k] for f, k in _MF.items()}
    r0 = 5 if bd == 12 else 3
    r1s = 9 if bd == 12 else 11                # single-list round
    hi = (1 << bd) - 1
    v0 = _mc_list(ref_flat, sv, 0, T, r0, ftab, ar)
    if comp:
        v1 = _mc_list(ref_flat, sv, 1, T, r0, ftab, ar)
        p0 = _round2(v0, 7)                    # compound r1 = 7
        p1 = _round2(v1, 7)
        s = sv["w0"][:, None, None] * p0 + sv["w1"][:, None, None] * p1
        sh = sv["bshift"][:, None, None]       # >= 1 on every compound lane
        out = ((s + (1 << (sh - 1))) >> sh).clamp(0, hi)
    else:
        out = _round2(v0, r1s).clamp(0, hi)
    ii = ar[:T][None, :, None]
    jj = ar[:T][None, None, :]
    pixmask = (ii < sv["h"][:, None, None]) & (jj < sv["w"][:, None, None])
    fidx = (sv["base"][:, None, None] +
            (sv["y"][:, None, None] + ii) * sv["stride"][:, None, None] +
            sv["x"][:, None, None] + jj)
    fidx = torch.where(pixmask, fidx, n)
    frame[fidx.reshape(-1).long()] = out.reshape(-1)


@functools.lru_cache(maxsize=None)
def _consts(device):
    """(filter table, index ramp) on `device`, uploaded once."""
    return (tracing.to_device(_FTAB, device),
            torch.arange(128 + 7, dtype=torch.int32, device=device))


def mc_into(frame, ref_flat, lanes, config):
    """All MC lanes of one frame, in place: `frame` is a flat int32
    [n + 1] buffer whose last slot is the trash slot.  ref_flat: packed
    reference planes (uint8 or int32); lanes: {(T, comp): [N, F] int32}
    on the same device; config: (((T, comp, N), ...), bd).  A CUDA frame
    runs the kernel, a CPU frame the plain version."""
    dev = frame.device
    if dev.type == "cpu":
        _mc_plain(frame, ref_flat, lanes, config)
    elif dev.type == "cuda":
        _mc_kernel(frame, ref_flat, lanes, config)
    else:
        raise ValueError(f"mc_into: unsupported device {dev}")


def _mc_plain(frame, ref_flat, lanes, config):
    """The plain version of the pass: `_mc_bucket` for each bucket, on
    any device (`mc_into`'s arguments)."""
    buckets, bd = config
    n = frame.shape[0] - 1
    ftab, ar = _consts(frame.device)
    with no_device_sync(frame.device):
        for (T, comp, _n) in buckets:
            _mc_bucket(frame, n, ref_flat, lanes[(T, comp)], T, comp, bd,
                       ftab, ar)


def _mc_kernel(frame, ref_flat, lanes, config):
    """The pass on the card: one `mc_frame` launch for every bucket with
    lanes, on the frame's device and its current stream, counted in
    `launches`.  Raises on inputs the kernel does not take or a failed
    launch; reads nothing back from the device."""
    global launches
    buckets, bd = config
    buckets = [b for b in buckets if b[2] > 0]
    if not buckets:
        return
    dev = frame.device
    if len(buckets) > MAX_BUCKETS or bd not in (8, 10, 12):
        raise ValueError(f"mc_into: {len(buckets)} buckets at {bd} bits, "
                         f"the kernel takes up to {MAX_BUCKETS} at 8, 10 "
                         f"or 12")
    if frame.dtype != torch.int32 or frame.ndim != 1 or \
            not frame.is_contiguous():
        raise ValueError("mc_into: the frame must be a flat contiguous "
                         "int32 buffer")
    if ref_flat.device != dev or ref_flat.dtype not in (torch.uint8,
                                                        torch.int32) or \
            ref_flat.ndim != 1 or not ref_flat.is_contiguous() or \
            ref_flat.numel() == 0:
        raise ValueError(f"mc_into: the reference must be flat contiguous "
                         f"uint8 or int32 on {dev}, got {ref_flat.dtype} "
                         f"on {ref_flat.device}")
    for T, comp, n in buckets:
        rows = lanes[(T, comp)]
        if T not in (4, 8, 16, 32, 64, 128) or comp not in (0, 1) or \
                rows.device != dev or rows.dtype != torch.int32 or \
                tuple(rows.shape) != (n, len(MC_FIELDS)) or \
                not rows.is_contiguous():
            raise ValueError(f"mc_into: bucket ({T}, {comp}) must be "
                             f"contiguous int32 [{n}, {len(MC_FIELDS)}] "
                             f"lane rows on {dev}")
    with torch.cuda.device(dev):
        # the first `_consts` of a device uploads (a synchronising copy),
        # so the parameters are made before `launch`'s no-sync guard
        params = _params(frame, ref_flat, lanes, (buckets, bd))
    launch("mc", "mc_frame", dev, params, len(buckets))
    launches += 1


def _params(frame, ref_flat, lanes, config):
    """The kernel's parameters in `_PARAMS` order: tensors where it takes
    a pointer, ints; a bucket the pass does not have is 0 throughout."""
    buckets, bd = config
    params = dict(frame=frame, ref=ref_flat, ftab=_consts(frame.device)[0],
                  ref_len=ref_flat.shape[0],
                  ref_bytes=ref_flat.element_size(), bd=bd,
                  nb=len(buckets))
    for b, (T, comp, n) in enumerate(buckets):
        params.update({f"rows{b}": lanes[(T, comp)], f"t{b}": T,
                       f"comp{b}": comp, f"n{b}": n})
    return param_list(_PARAMS, params)


def run_mc(frame0, ref_flat, lanes, config):
    """`mc_into` on a copy of the flat int32 [n] frame `frame0`.  Returns
    the new [n] frame; frame0 is left as it was."""
    n = frame0.shape[0]
    frame = torch.empty(n + 1, dtype=torch.int32, device=frame0.device)
    frame[:n] = frame0
    mc_into(frame, ref_flat, lanes, config)
    return frame[:n]
