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
  included, at 8 and 10 bits, on levels of a conformant range;
- the packed route (`pack_buckets`, then `residuals_packed` on a CPU
  buffer: the plain `_residuals_plain`, no kernel launch) equals the
  JAX `residual_bucket` of each bucket on the subset's extreme levels,
  all buckets in one call; another device is refused;
- on a card (`gpu` marker): the kernel `csrc/itx.cu`, one launch a
  call, is byte-equal to the plain route on the card and to its CPU run
  on every valid transform at 8, 10 and 12 bits, conformant and extreme
  levels, and on spans of 65 blocks that fill several CTAs.
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


def _packed_subset(bd, extreme, cases, B=6):
    """`pack_buckets` of one bucket of B blocks for each case: extreme or
    conformant levels; also returns the buckets."""
    from av1dec_tpu_torch.ops.spec import dequant
    rng = np.random.default_rng(bd + 17)
    bi = dequant._BD_IDX[bd]
    buckets = []
    for tsz, tt in cases:
        w, h = S.TX_DIMS[tsz]
        m = min(w, 32) * min(h, 32)
        if extreme:
            levels = _extreme_levels(rng, B, m)
            dcq, acq = _quantizers(rng, B, min(bd, 10))
        else:
            # a conformant range, halved at 12 bits (see
            # tests/test_torch_itx_shim.py `_buckets`)
            e = min(bd, 11)
            q = rng.integers(0, 256, (2, B))
            dcq = DC_Q[bi, q[0]].astype(np.int32)
            acq = AC_Q[bi, q[1]].astype(np.int32)
            lim = np.maximum(1, (1 << (e + 3)) // acq)[:, None]
            levels = np.floor(rng.uniform(-1, 1, (B, m)) * (lim + 1))
            levels[:, 0] = np.floor(rng.uniform(-1, 1, B) *
                                    np.maximum(1, (1 << (e + 6)) // dcq))
            levels[rng.random(levels.shape) < 0.6] = 0
            levels = levels.astype(np.int32)
        buckets.append((levels, dcq, acq, tsz, tt))
    return T.pack_buckets(buckets), buckets


def _unpacked(flat, spans):
    return [flat[o0:o0 + B * S.TX_DIMS[tsz][0] * S.TX_DIMS[tsz][1]]
            .reshape(B, S.TX_DIMS[tsz][1], S.TX_DIMS[tsz][0])
            for tsz, _, _, B, _, o0 in spans]


def test_residuals_packed_plain_route_matches_jax():
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels import itx as K
    (buf, spans, words), buckets = _packed_subset(8, True, SUBSET_BELOW_64)
    before = T.launches
    got = T.residuals_packed(torch.as_tensor(buf), spans, words, 8)
    assert T.launches == before and got.dtype == torch.int32
    assert got.shape == (words,) and len(spans) == len(buckets)
    for (levels, dcq, acq, tsz, tt), res in zip(
            buckets, _unpacked(got.numpy(), spans)):
        want = K.residual_bucket(jnp.asarray(levels), jnp.asarray(dcq),
                                 jnp.asarray(acq), tsz, tt, 8)
        np.testing.assert_array_equal(res, np.asarray(want),
                                      err_msg=f"{tsz} {tt}")
    with pytest.raises(ValueError, match="unsupported device"):
        T.residuals_packed(torch.zeros(8, dtype=torch.int32,
                                       device="meta"), spans, words, 8)


def test_residuals_kernel_refuses_what_it_does_not_take():
    """The launch's checks, which run before the kernel is loaded; the
    packing's check of the residual offsets, which the descriptors carry
    to the card; and the wrapper's, on every device, of how far the
    packing says they reach."""
    (buf, spans, words), _ = _packed_subset(8, False, [(0, 0), (3, 9)])
    buf = torch.as_tensor(buf)
    for args, match in (
            ((buf.to(torch.int64), spans, words, 8), "int32"),
            ((buf, spans, words, 9), "bit depth"),
            ((buf, [(3, 1) + spans[1][2:]], words, 8), "does not take"),
            ((buf[:-1], spans, words, 8), "beyond")):
        with pytest.raises(ValueError, match=match):
            T._residuals_kernel(*args)
    tsz, out = np.array([0, 3]), np.array([0, 16])
    src = np.zeros(16 + 32 * 32, np.int32)
    for o, w in ((out, 16 + 32 * 32 - 1), (out - 1, 16 + 32 * 32)):
        with pytest.raises(ValueError, match="beyond"):
            T.pack_blocks(tsz, [0, 9], o, [4, 4], [4, 4], src, [0, 16], w)
    buf2, spans2, words2 = T.pack_blocks(tsz, [0, 9], out, [4, 4], [4, 4],
                                         src, [0, 16], 16 + 32 * 32)
    assert spans2.reach == words2
    for s, w in ((spans2, words2 - 1), (list(spans2), words2)):
        with pytest.raises(ValueError, match="pack_blocks"):
            T.residuals_packed(torch.as_tensor(buf2), s, w, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cuda_residuals_match_plain(bd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run with `pytest -m gpu` on the card)")
    # every valid transform, 4 blocks each, conformant and
    # extreme levels; and spans of 65 blocks (several CTAs, the last
    # part-filled) of DCT, flipped ADST, identity and flipped 1-D types
    multi = [c for c in T.valid_transforms() if c[1] in (0, 6, 9, 14, 15)]
    for extreme, cases, B in ((False, T.valid_transforms(), 4),
                              (True, T.valid_transforms(), 4),
                              (False, multi, 65)):
        (buf, spans, words), _ = _packed_subset(bd, extreme, cases, B=B)
        cpu = T.residuals_packed(torch.as_tensor(buf), spans, words, bd)
        dev = torch.as_tensor(buf, device="cuda")
        plain = T._residuals_plain(dev, spans, words, bd)
        before = T.launches
        got = T.residuals_packed(dev, spans, words, bd)
        assert T.launches == before + 1
        assert torch.equal(got, plain) and torch.equal(got.cpu(), cpu)
