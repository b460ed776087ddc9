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
"""
import math

import torch

from av1dec_tpu_torch.ops.spec import itx as S

# Tx_Scale by pixel count: (pels > 256) + (pels > 1024)
_TX_SCALE = {3: 1, 9: 1, 10: 1, 17: 1, 18: 1, 4: 2, 11: 2, 12: 2}


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
