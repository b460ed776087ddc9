"""Batched dequantization and inverse transforms on a torch device (B7).
[SPEC §7.12.3, §7.13.3]

Port of `av1dec_tpu.ops.kernels.itx`.  The 1-D butterflies of the spec
model (`ops/spec/itx.py`: `_DCT`, `_ADST`, `iidentity`) use only +, -,
* and >> on lists of lane arrays, so running them on int32 tensors gives
a transform vectorised over a whole (tx_size, tx_type) bucket, on the
CPU or on a card, as the JAX package traces them with jnp arrays.

int32 throughout, as in the JAX package: the dequant product
`abs(level) * q` and the butterflies wrap as JAX's int32 arithmetic
does (the NumPy spec model computes in int64 and does not wrap; on a
conformant stream the two agree).  Buckets run at their exact batch
size: the JAX package's power-of-two padding only keeps its jit keys
stable.  `residual_step` is not ported: nothing calls it.

`residuals_packed` runs every bucket of a call at once, from one packed
int32 buffer (`pack_blocks`, or `pack_buckets` for bucket lists: a
descriptor table, then every block's coded levels); each
block's residual goes to its descriptor's `out` offset.  A CUDA buffer
runs the hand-written kernel `csrc/itx.cu`, one launch for all the
blocks (counted in `launches`); a CPU buffer runs the plain version
`_residuals_plain`, `residual_bucket` per bucket; nothing else is
accepted.  The descriptors are on the device by the call, so the
packing records how far the blocks' residuals reach (`Spans.reach`) and
the wrapper holds that to the output's words on every device.
"""
import math

import numpy as np
import torch

from av1dec_tpu_torch.ops.kernels.cuda_build import launch
from av1dec_tpu_torch.ops.spec import itx as S

# Tx_Scale by pixel count: (pels > 256) + (pels > 1024)
_TX_SCALE = {3: 1, 9: 1, 10: 1, 17: 1, 18: 1, 4: 2, 11: 2, 12: 2}

# launches of the CUDA residual kernel in this process (one per packed
# call with blocks)
launches = 0
# columns of the descriptor table, one row a transform block (`csrc/itx.cu`
# enum Desc): its levels' and its residual's offsets, its transform and
# its quantizers
DESC_FIELDS = ["lev", "out", "tx_size", "tx_type", "dcq", "acq"]
# the kernel's int64 parameter array (enum Param): pointers and ints,
# then the number of spans, each span's (tx_size, tx_type, first block,
# blocks) after it
_PARAMS = ["out", "desc", "levels", "levels_len", "bd", "spans"]
# spans a call, at most (every valid transform is 185)
MAX_SPANS = 190
# by tx_size: the coded levels of a block (64 -> 32 clipped) and its
# residual pixels
LEVELS = np.array([min(w, 32) * min(h, 32) for w, h in S.TX_DIMS])
PIXELS = np.array([w * h for w, h in S.TX_DIMS])


def valid_transforms():
    """Every (tx_size, tx_type) a stream can code: ADST up to 16 points,
    64-point transforms DCT only."""
    out = []
    for tsz, (w, h) in enumerate(S.TX_DIMS):
        for tt, (ck, rk, _, _) in S.TX_1D.items():
            if (ck == 1 and h > 16) or (rk == 1 and w > 16):
                continue
            if (w == 64 or h == 64) and tt != 0:
                continue
            out.append((tsz, tt))
    return out


def _round_shift(x, bit):
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


def _apply_1d(kind, vecs, n):
    if kind == 0:
        return S._DCT[n](vecs)
    if kind == 1:
        return S._ADST[n](vecs)
    return S.iidentity(vecs, n)


def inverse_transform_batch(coeffs, tx_size, tx_type, bd=8):
    """coeffs: [B, adj_h, adj_w] integer tensor (coded layout, 64 -> 32
    clipped).  Returns the residual [B, h, w] int32 on coeffs' device."""
    w, h = S.TX_DIMS[tx_size]
    adj_w, adj_h = min(w, 32), min(h, 32)
    ck, rk, ud, lr = S.TX_1D[tx_type]
    row_hi = (1 << (bd + 7)) - 1           # rowClampRange [SPEC §7.13.3]
    col_hi = (1 << (max(bd + 6, 16) - 1)) - 1
    coeffs = coeffs.to(torch.int32)
    buf = torch.zeros((coeffs.shape[0], h, w), dtype=torch.int32,
                      device=coeffs.device)
    buf[:, :adj_h, :adj_w] = coeffs

    if (int(math.log2(w)) - int(math.log2(h))) % 2 != 0:
        buf = _round_shift(buf * S.NEW_INV_SQRT2, S.COS_BIT)
    buf = buf.clamp(-row_hi - 1, row_hi)

    # row transforms along width; lanes are [B, h]
    rows_out = _apply_1d(rk, [buf[:, :, j] for j in range(w)], w)
    buf = torch.stack(rows_out, dim=2)           # [B, h, w]
    buf = _round_shift(buf, S._ROW_SHIFT[(w, h)]).clamp(-col_hi - 1, col_hi)
    cols_out = _apply_1d(ck, [buf[:, r, :] for r in range(h)], h)
    res = _round_shift(torch.stack(cols_out, dim=1), 4)   # [B, h, w]
    if ud:
        res = res.flip(1)
    if lr:
        res = res.flip(2)
    return res


def dequant_batch(levels, qvec, tx_size, bd, lossless):
    """levels: [B, n] int32, qvec: [B, n] int32 dequant factors (dc at
    position 0, ac elsewhere).  Returns the dequantized coefficients
    [B, n] int32.  `lossless` is unused, as in the JAX function.
    [SPEC §7.12.3]"""
    shift = _TX_SCALE.get(tx_size, 0)
    mag = ((levels.abs() * qvec) & 0xFFFFFF) >> shift
    d = torch.where(levels < 0, -mag, mag)
    # CoeffMin/CoeffMax clamp [SPEC §7.12.3]
    hi = (1 << (7 + bd)) - 1
    return d.clamp(-hi - 1, hi)


def residual_bucket(levels, dcq, acq, tx_size, tx_type, bd):
    """Dequant + inverse transform of one (tx_size, tx_type) bucket:
    levels [B, n] int32 (coded layout), dcq / acq [B] int32 per-block
    quantizers, all on one device.  Returns the residual [B, h, w]
    int32 there.  [SPEC §7.12.3 dequant, §7.13.3 inverse transform]"""
    w, h = S.TX_DIMS[tx_size]
    adj_w, adj_h = min(w, 32), min(h, 32)
    levels = levels.to(torch.int32)
    q = torch.cat([dcq.to(torch.int32)[:, None],
                   acq.to(torch.int32)[:, None].expand(
                       -1, levels.shape[1] - 1)], dim=1)
    d = dequant_batch(levels, q, tx_size, bd, False)
    return inverse_transform_batch(d.reshape(-1, adj_h, adj_w), tx_size,
                                   tx_type, bd)


class Spans(list):
    """`pack_blocks`' spans [(tx_size, tx_type, first block, blocks,
    levels offset, residual offset)], with `reach`: the largest `out` +
    pixels of any of their blocks, the residual words the blocks
    need."""

    def __init__(self, spans, reach):
        super().__init__(spans)
        self.reach = reach


def pack_buckets(buckets):
    """One int32 buffer for every block of `buckets` [(levels [B, n],
    dcq [B], acq [B], tx_size, tx_type)] (host arrays, levels in coded
    layout; no bucket empty, no two neighbours of one transform): the
    [blocks, len(DESC_FIELDS)] descriptor table, then the levels of
    every block in order (`pack_blocks`, the residuals end to end).
    Returns (buffer, spans, residual words): spans [(tx_size, tx_type,
    first block, blocks, levels offset, residual offset)] a bucket, the
    offsets into the levels part and into the [words] residual
    output."""
    counts = [len(b[0]) for b in buckets]
    tsz = np.repeat([b[3] for b in buckets], counts).astype(np.int64)
    tt = np.repeat([b[4] for b in buckets], counts)
    px, n = PIXELS[tsz], LEVELS[tsz]
    return pack_blocks(
        tsz, tt, np.cumsum(px) - px,
        np.concatenate([np.zeros(0, np.int32)] + [b[1] for b in buckets]),
        np.concatenate([np.zeros(0, np.int32)] + [b[2] for b in buckets]),
        np.concatenate([np.zeros(0, np.int32)] +
                       [np.asarray(b[0]).reshape(-1) for b in buckets]),
        np.cumsum(n) - n, int(px.sum()))


def pack_blocks(tsz, tt, out, dcq, acq, src, src_off, words):
    """One int32 buffer for blocks sorted by (tx_size, tx_type), given
    as arrays, one entry a block: its transform, its residual's offset
    `out` into the [words] output, its quantizers, and its coded levels,
    `LEVELS[tx_size]` words of `src` from `src_off`.  The buffer is the
    [blocks, len(DESC_FIELDS)] descriptor table, then the levels of
    every block in order, gathered with one fancy index.  Returns
    (buffer, spans, words): `Spans`, a span a run of one transform (its
    residual offset is its first block's).  Raises ValueError where a
    block's residual leaves the output."""
    tsz, tt = np.asarray(tsz, np.int64), np.asarray(tt, np.int64)
    out = np.asarray(out, np.int64)
    B = len(tsz)
    reach = int((out + PIXELS[tsz]).max()) if B else 0
    if B and (out.min() < 0 or reach > words):
        raise ValueError("pack_blocks: a residual beyond the output")
    n = LEVELS[tsz]
    lev = np.cumsum(n) - n
    total = int(n.sum())
    F = len(DESC_FIELDS)
    # at least one level word: the kernel's levels are never empty
    buf = np.zeros(B * F + max(total, 1), np.int32)
    desc = buf[:B * F].reshape(B, F)
    desc[:, 0], desc[:, 1], desc[:, 2], desc[:, 3] = lev, out, tsz, tt
    desc[:, 4], desc[:, 5] = dcq, acq
    buf[B * F:B * F + total] = src[
        np.repeat(np.asarray(src_off, np.int64) - lev, n) +
        np.arange(total)]
    key = tsz * 16 + tt
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if B else []
    ends = np.r_[first[1:], B]
    spans = [(int(tsz[b]), int(tt[b]), int(b), int(e - b), int(lev[b]),
              int(out[b])) for b, e in zip(first, ends)]
    return buf, Spans(spans, reach), words


def residuals_packed(buf, spans, words, bd):
    """The residuals of `pack_buckets`' or `pack_blocks`' buffer on its
    device: int32 [words], each block's [h, w] residual at its
    descriptor's `out` (words no block covers are left undefined).  A
    CUDA buffer runs the kernel, a CPU buffer the plain version.  Raises
    ValueError, on every device, for spans that do not say how far
    their residuals reach (not `Spans`) or reach beyond `words`."""
    reach = getattr(spans, "reach", None)
    if reach is None or reach > words:
        raise ValueError("residuals_packed: spans not from pack_blocks, "
                         "or a residual beyond the output")
    dev = buf.device
    if dev.type == "cpu":
        return _residuals_plain(buf, spans, words, bd)
    if dev.type == "cuda":
        return _residuals_kernel(buf, spans, words, bd)
    raise ValueError(f"residuals_packed: unsupported device {dev}")


def _split(buf, spans):
    """(descriptor table, levels) views of a packed buffer."""
    blocks = sum(s[3] for s in spans)
    k = blocks * len(DESC_FIELDS)
    return buf[:k].view(blocks, len(DESC_FIELDS)), buf[k:]


def _residuals_plain(buf, spans, words, bd):
    """The plain version: `residual_bucket` on each span of the packed
    buffer, on any device (`residuals_packed`'s arguments)."""
    desc, levs = _split(buf, spans)
    out = torch.empty(words, dtype=torch.int32, device=buf.device)
    for tsz, tt, b0, B, l0, _ in spans:
        w, h = S.TX_DIMS[tsz]
        n = min(w, 32) * min(h, 32)
        d = desc[b0:b0 + B]
        res = residual_bucket(levs[l0:l0 + B * n].view(B, n), d[:, 4],
                              d[:, 5], tsz, tt, bd)
        at = d[:, 1, None].long() + torch.arange(w * h, device=buf.device)
        out[at.reshape(-1)] = res.reshape(-1)
    return out


def _residuals_kernel(buf, spans, words, bd):
    """The residuals on the card: one `itx_residuals` launch for every
    block, on the buffer's device and its current stream, counted in
    `launches`.  Raises on inputs the kernel does not take or a failed
    launch."""
    global launches
    dev = buf.device
    if buf.dtype != torch.int32 or buf.ndim != 1 or \
            not buf.is_contiguous() or bd not in (8, 10, 12):
        raise ValueError("residuals_packed: the buffer must be flat "
                         "contiguous int32, the bit depth 8, 10 or 12")
    valid = set(valid_transforms())
    if any((tsz, tt) not in valid for tsz, tt, *_ in spans) or \
            len(spans) > MAX_SPANS:
        raise ValueError(f"residuals_packed: a (tx_size, tx_type) the "
                         f"kernel does not take, or more than {MAX_SPANS} "
                         f"spans")
    blocks = sum(s[3] for s in spans)
    levels = buf.numel() - blocks * len(DESC_FIELDS)
    for tsz, _, _, B, l0, _ in spans:
        if l0 + B * int(LEVELS[tsz]) > levels:
            raise ValueError("residuals_packed: a span beyond the levels")
    out = torch.empty(words, dtype=torch.int32, device=dev)
    if blocks == 0:
        return out
    launch("itx", "itx_residuals", dev, _params(out, buf, spans, bd), blocks)
    launches += 1
    return out


def _params(out, buf, spans, bd):
    """The kernel's parameters in `_PARAMS` order, then each span's
    (tx_size, tx_type, first block, blocks): tensors where it takes a
    pointer, ints."""
    desc, levs = _split(buf, spans)
    return [out, desc, levs, levs.shape[0], bd, len(spans)] + \
        [v for tsz, tt, b0, B, _, _ in spans for v in (tsz, tt, b0, B)]
