"""B7, the device residuals of av1dec_tpu_torch (`ops/kernels/itx.py`),
on the CPU:

- `residual_bucket`, `inverse_transform_batch` and `dequant_batch` equal
  the JAX package's functions byte for byte on the
  `tests/test_itx_kernels.py` subset at 8 bits (10 bits and 64-point
  transforms: the two files beside this one), with extreme levels
  (|level| up to 2^20, qindex up to 255), where both wrap in int32 as
  JAX does;
- `residual_bucket` equals the NumPy spec model (`dequant_batch`, then
  `inverse_transform_lanes`) on every valid (tx_size, tx_type), rect-64
  included, at 8 and 10 bits, on levels of a conformant range.
"""
import numpy as np
import pytest
import torch

from av1dec_tpu_torch.ops.kernels import itx as T
from av1dec_tpu_torch.ops.spec import itx as S
from av1dec_tpu_torch.ops.tables_data import AC_Q, DC_Q

# tests/test_itx_kernels.py's subset (that file leaves rect-64 out)
SUBSET = [(tsz, tt) for tsz, tt in T.valid_transforms()
          if (S.TX_DIMS[tsz][0] == 64) == (S.TX_DIMS[tsz][1] == 64)][3::19] \
    + [(0, 0), (4, 0), (3, 0), (6, 3), (13, 9)]
# its cases below 64 points (JAX compiles a 64-point transform slowly:
# tests/test_torch_itx64.py; 10-bit: tests/test_torch_itx_10bit.py)
SUBSET_BELOW_64 = [c for c in SUBSET if max(S.TX_DIMS[c[0]]) < 64]


def _quantizers(rng, B, bd, hi_q=255):
    bi = {8: 0, 10: 1}[bd]
    q = rng.integers(0, hi_q + 1, (2, B))
    return (DC_Q[bi, q[0]].astype(np.int32), AC_Q[bi, q[1]].astype(np.int32))


def _extreme_levels(rng, B, n):
    """Levels with the extremes a bucket can carry: +-2^20, zeros and
    ordinary values."""
    lv = rng.integers(-(1 << 20), (1 << 20) + 1, (B, n))
    lv[0, :] = 1 << 20
    lv[1, :] = -(1 << 20)
    lv[2, ::2] = 0
    lv[3] = rng.integers(-40, 41, n)
    return lv.astype(np.int32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def check_against_jax(tsz, tt, bd, composed=False):
    """The port's three B7 functions == the JAX package's on extreme
    levels and on coefficients over the whole row clamp range.
    `composed`: hold `residual_bucket` to the JAX `inverse_transform_batch`
    of the JAX `dequant_batch` (the body of the JAX `residual_bucket`),
    so that a 64-point transform is compiled once, not twice."""
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels import itx as K
    rng = np.random.default_rng(tsz * 31 + tt + bd)
    w, h = S.TX_DIMS[tsz]
    aw, ah = min(w, 32), min(h, 32)
    B = 6
    levels = _extreme_levels(rng, B, aw * ah)
    dcq, acq = _quantizers(rng, B, bd)
    qvec = np.repeat(acq[:, None], aw * ah, 1)
    qvec[:, 0] = dcq
    want_dq = np.asarray(K.dequant_batch(jnp.asarray(levels),
                                         jnp.asarray(qvec), tsz, bd, False))
    np.testing.assert_array_equal(
        T.dequant_batch(_t(levels), _t(qvec), tsz, bd, False).numpy(),
        want_dq)
    if composed:
        want = K.inverse_transform_batch(
            jnp.asarray(want_dq.reshape(B, ah, aw)), tsz, tt, bd)
    else:
        want = K.residual_bucket(jnp.asarray(levels), jnp.asarray(dcq),
                                 jnp.asarray(acq), tsz, tt, bd)
    got = T.residual_bucket(_t(levels), _t(dcq), _t(acq), tsz, tt, bd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    lim = 1 << (bd + 7)
    coeffs = rng.integers(-lim, lim, (B, ah, aw)).astype(np.int32)
    np.testing.assert_array_equal(
        T.inverse_transform_batch(_t(coeffs), tsz, tt, bd).numpy(),
        np.asarray(K.inverse_transform_batch(jnp.asarray(coeffs), tsz, tt,
                                             bd)))


@pytest.mark.parametrize("tsz,tt", SUBSET_BELOW_64)
def test_b7_matches_jax(tsz, tt):
    check_against_jax(tsz, tt, 8)


@pytest.mark.parametrize("bd", [8, 10])
def test_b7_matches_numpy_spec_on_every_valid_transform(bd):
    from av1dec_tpu_torch.ops.spec import dequant
    cases = T.valid_transforms()
    assert len(cases) > len(SUBSET) and (17, 0) in cases and (11, 0) in cases
    rng = np.random.default_rng(bd)
    for tsz, tt in cases:
        w, h = S.TX_DIMS[tsz]
        aw, ah = min(w, 32), min(h, 32)
        B = 5
        qidx = rng.integers(0, 256, B)
        dcd = rng.integers(-8, 9, B)
        acd = rng.integers(-8, 9, B)
        bi = {8: 0, 10: 1}[bd]
        dcq = DC_Q[bi, np.clip(qidx + dcd, 0, 255)].astype(np.int32)
        acq = AC_Q[bi, np.clip(qidx + acd, 0, 255)].astype(np.int32)
        # a conformant range: sparse levels whose dequantized values stay
        # within 2^(bd+6) at DC and 2^(bd+3) elsewhere, so that no
        # intermediate leaves int32
        lim = np.maximum(1, (1 << (bd + 3)) // acq)[:, None]
        levels = np.floor(rng.uniform(-1, 1, (B, aw * ah)) * (lim + 1))
        levels[:, 0] = np.floor(rng.uniform(-1, 1, B) *
                                np.maximum(1, (1 << (bd + 6)) // dcq))
        levels = levels.astype(np.int64)
        levels[rng.random(levels.shape) < 0.6] = 0
        dq = dequant.dequant_batch(levels, tsz, qidx, bd, dcd, acd)
        want = S.inverse_transform_lanes(dq, tsz, tt, bd)
        got = T.residual_bucket(_t(levels.astype(np.int32)), _t(dcq),
                                _t(acq), tsz, tt, bd)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"tx_size {tsz} tx_type {tt}")
