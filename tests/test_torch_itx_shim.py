"""The residual kernel `csrc/itx.cu` (B7, one launch for every transform
block of a call), compiled with g++ against the CPU shim
`tests/cuda_cpu_shim.h` and run on the host: the exact source, its
blocks one after another and its threads as fibers of one OS thread.

- On every valid (tx_size, tx_type) at 8, 10 and 12 bits, all packed
  into one call as `residuals_device` packs a frame's buckets, the
  kernel's residuals are byte-equal to the NumPy spec model (dequant,
  then the inverse transform) and to the plain route
  (`_residuals_plain`, `residual_bucket` per bucket), on levels of a
  conformant range.
- On spans of 2k + 1 blocks of every tx_size, k the blocks of one of the
  kernel's CTAs (DCT, and the flipped ADST, identity and 1-D types where
  they are valid), so that each span fills two CTAs and part of a
  third, the same against the plain route.
- With the blocks' residual offsets shuffled (as the device path's
  slots in the scan's buffer lie), each block's residual at its
  descriptor's offset, in the kernel and the plain route alike.
- On extreme levels (|level| up to 2^20), where the plain route wraps
  in int32, the kernel wraps the same way: byte-equal to the plain
  route.
- The source's constants (descriptor columns, parameters, the cosine
  and sine tables, the row shifts, Tx_Scale and the 1-D kinds) are the
  Python side's.

Skips when g++ is missing (decided inside the tests).
"""
import re

import numpy as np
import pytest
import torch

from av1dec_tpu_torch.ops.kernels import itx
from av1dec_tpu_torch.ops.spec import dequant
from av1dec_tpu_torch.ops.spec import itx as S
from av1dec_tpu_torch.ops.tables_data import AC_Q, DC_Q
from torch_port_helpers import _ROOT, shim_build, shim_run

_CU = f"{_ROOT}/av1dec_tpu_torch/csrc/itx.cu"
BLOCKS = 2  # transform blocks of each (tx_size, tx_type) in a call


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    exe = shim_build(tmp_path_factory.mktemp("itx_shim"), "itx",
                     "itx_residuals")
    if exe is None:
        pytest.skip("needs g++ to build the CPU shim")
    return exe


def _buckets(bd, rng, extreme):
    """[(levels, qidx, dc delta, ac delta, tx_size, tx_type)] of every
    valid transform; levels of a conformant range (dequantized within
    2^(e+6) at DC and 2^(e+3) elsewhere, e = min(bd, 11), so that no
    intermediate leaves int32: at 12 bits a DC past 2^17 takes an
    identity-16 row past the 8 + BitDepth bits a conformant stream keeps
    [SPEC §7.13.3], and the plain route's int32 product, the JAX
    package's, wraps where the NumPy spec's int64 does not), or
    `extreme` ones."""
    bi = dequant._BD_IDX[bd]
    e = min(bd, 11)
    out = []
    for tsz, tt in itx.valid_transforms():
        w, h = S.TX_DIMS[tsz]
        m = min(w, 32) * min(h, 32)
        qidx = rng.integers(0, 256, BLOCKS)
        dcd = rng.integers(-8, 9, BLOCKS)
        acd = rng.integers(-8, 9, BLOCKS)
        if extreme:
            levels = rng.integers(-(1 << 20), (1 << 20) + 1, (BLOCKS, m))
        else:
            dcq = DC_Q[bi, np.clip(qidx + dcd, 0, 255)]
            acq = AC_Q[bi, np.clip(qidx + acd, 0, 255)]
            lim = np.maximum(1, (1 << (e + 3)) // acq)[:, None]
            levels = np.floor(rng.uniform(-1, 1, (BLOCKS, m)) * (lim + 1))
            levels[:, 0] = np.floor(rng.uniform(-1, 1, BLOCKS) *
                                    np.maximum(1, (1 << (e + 6)) // dcq))
            levels = levels.astype(np.int64)
            levels[rng.random(levels.shape) < 0.6] = 0
        out.append((levels.astype(np.int64), qidx, dcd, acd, tsz, tt))
    return out


def _packed(buckets, bd):
    """`residuals_device`'s packing of `buckets`."""
    bi = dequant._BD_IDX[bd]
    return itx.pack_buckets([
        (lv.astype(np.int32), DC_Q[bi, np.clip(q + dc, 0, 255)]
         .astype(np.int32), AC_Q[bi, np.clip(q + ac, 0, 255)]
         .astype(np.int32), tsz, tt)
        for lv, q, dc, ac, tsz, tt in buckets])


def _kernel(exe, d, buf, spans, words, bd):
    """The shim's residuals of a packed buffer: int32 [words]."""
    buf = torch.as_tensor(buf)
    out = torch.zeros(words, dtype=torch.int32)
    blocks = sum(s[3] for s in spans)
    rc, got, err = shim_run(exe, d, itx._params(out, buf, spans, bd),
                            blocks, {0})
    assert rc == 0, err
    return np.frombuffer(got[0], np.int32)


def _unpack(flat, spans):
    return [flat[o0:o0 + B * S.TX_DIMS[tsz][0] * S.TX_DIMS[tsz][1]]
            .reshape(B, S.TX_DIMS[tsz][1], S.TX_DIMS[tsz][0])
            for tsz, _, _, B, _, o0 in spans]


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_shim_matches_spec_and_plain(bd, shim, tmp_path):
    rng = np.random.default_rng(40 + bd)
    buckets = _buckets(bd, rng, extreme=False)
    buf, spans, words = _packed(buckets, bd)
    got = _kernel(shim, tmp_path, buf, spans, words, bd)
    plain = itx._residuals_plain(torch.as_tensor(buf), spans, words,
                                 bd).numpy()
    np.testing.assert_array_equal(got, plain)
    for (lv, q, dc, ac, tsz, tt), res in zip(buckets, _unpack(got, spans)):
        spec = S.inverse_transform_lanes(
            dequant.dequant_batch(lv, tsz, q, bd, dc, ac), tsz, tt, bd)
        np.testing.assert_array_equal(res, spec, err_msg=f"{tsz} {tt}")
    assert np.abs(got).max() > 0


# transform types of the multi-CTA spans: DCT, FLIPADST both ways,
# identity, and the 1-D types with a flip (where valid for the size)
SPAN_TYPES = (0, 6, 9, 14, 15)


def _blocks_per_cta(tsz):
    """The blocks of one CTA of `itx.cu` (128 threads): a thread a coded
    row and a thread a column, two for 32 and 64 points."""
    w, h = S.TX_DIMS[tsz]
    rows = min(h, 32) * (2 if w >= 32 else 1)
    return 128 // max(rows, w * (2 if h >= 32 else 1))


@pytest.mark.parametrize("bd", [8, 12])
def test_shim_spans_over_several_ctas(bd, shim, tmp_path):
    cases = [c for c in itx.valid_transforms() if c[1] in SPAN_TYPES]
    assert {tsz for tsz, _ in cases} == set(range(len(S.TX_DIMS)))
    rng = np.random.default_rng(60 + bd)
    buckets = []
    for lv, q, dc, ac, tsz, tt in _buckets(bd, rng, False):
        if (tsz, tt) in cases:
            n = 2 * _blocks_per_cta(tsz) + 1
            r = -(-n // BLOCKS)
            buckets.append((lv.repeat(r, 0)[:n], q.repeat(r)[:n],
                            dc.repeat(r)[:n], ac.repeat(r)[:n], tsz, tt))
    for b in buckets:
        b[0][1::2] = rng.permuted(b[0][1::2], axis=1)
    buf, spans, words = _packed(buckets, bd)
    got = _kernel(shim, tmp_path, buf, spans, words, bd)
    plain = itx._residuals_plain(torch.as_tensor(buf), spans, words,
                                 bd).numpy()
    np.testing.assert_array_equal(got, plain)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("bd", [8, 10])
def test_shim_scattered_outs(bd, shim, tmp_path):
    """Blocks whose descriptors send their residuals out of span order
    (the device path's slots in the scan's buffer): the kernel and the
    plain route write each at its descriptor's `out`."""
    rng = np.random.default_rng(70 + bd)
    buf, spans, words = _packed(_buckets(bd, rng, extreme=False), bd)
    F = len(itx.DESC_FIELDS)
    blocks = sum(s[3] for s in spans)
    desc = buf[:blocks * F].reshape(blocks, F)
    px = itx.PIXELS[desc[:, 2]]
    # the blocks laid end to end in a shuffled order
    order = rng.permutation(blocks)
    out = np.empty(blocks, np.int64)
    out[order] = np.cumsum(px[order]) - px[order]
    moved = buf.copy()
    moved[:blocks * F].reshape(blocks, F)[:, 1] = out
    assert (out != desc[:, 1]).sum() > blocks // 2
    got = _kernel(shim, tmp_path, moved, spans, words, bd)
    plain = itx._residuals_plain(torch.as_tensor(moved), spans, words,
                                 bd).numpy()
    np.testing.assert_array_equal(got, plain)
    want = _kernel(shim, tmp_path, buf, spans, words, bd)
    for b in range(blocks):
        np.testing.assert_array_equal(
            got[out[b]:out[b] + px[b]],
            want[desc[b, 1]:desc[b, 1] + px[b]])


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_shim_extreme_levels_wrap_as_plain(bd, shim, tmp_path):
    rng = np.random.default_rng(50 + bd)
    buf, spans, words = _packed(_buckets(bd, rng, extreme=True), bd)
    got = _kernel(shim, tmp_path, buf, spans, words, bd)
    plain = itx._residuals_plain(torch.as_tensor(buf), spans, words,
                                 bd).numpy()
    np.testing.assert_array_equal(got, plain)


def _enum(src, name):
    body = re.search(r"enum %s : int \{(.*?)\};" % name, src, re.S)
    assert body, name
    return {k: int(v) for k, v in
            re.findall(r"(\w+) = (\d+)", body.group(1))}


def _table(src, name):
    body = re.search(r"%s(?:\[\w+\])+ = \{(.*?)\};" % name, src, re.S)
    assert body, name
    return [int(v) for v in re.findall(r"-?\d+", body.group(1))]


def test_itx_constants_locked():
    from av1dec_tpu_torch.ops.kernels import cuda_build
    with open(_CU) as f:
        src = f.read()
    desc = _enum(src, "Desc")
    assert desc.pop("kDescFields") == len(itx.DESC_FIELDS)
    assert desc == {"D_" + n.upper(): i
                    for i, n in enumerate(itx.DESC_FIELDS)}
    params = _enum(src, "Param")
    assert params.pop("kParams") == len(itx._PARAMS)
    assert params == {"P_" + n.upper(): i for i, n in enumerate(itx._PARAMS)}
    assert _table(src, "kCospi") == S.COSPI.tolist()
    assert _table(src, "kSinpi") == S.SINPI.tolist()
    assert _table(src, "kLog2W") == [w.bit_length() - 1
                                     for w, _ in S.TX_DIMS]
    assert _table(src, "kLog2H") == [h.bit_length() - 1
                                     for _, h in S.TX_DIMS]
    assert _table(src, "kRowShift") == [S._ROW_SHIFT[d] for d in S.TX_DIMS]
    assert _table(src, "kTxScale") == [itx._TX_SCALE.get(t, 0)
                                       for t in range(len(S.TX_DIMS))]
    assert _table(src, "kTx1d") == [v for t in range(16) for v in S.TX_1D[t]]
    assert int(re.search(r"kMaxSpans = (\d+);", src).group(1)) == \
        itx.MAX_SPANS >= len(itx.valid_transforms())
    assert f"kNewSqrt2 = {S.NEW_SQRT2};" in src
    assert f"kNewInvSqrt2 = {S.NEW_INV_SQRT2};" in src
    fns, argtypes = cuda_build.KERNELS["itx"]
    assert fns == ("itx_residuals",)
    sig = re.search(r'extern "C" int itx_residuals\((.*?)\)', src,
                    re.S).group(1)
    assert len(sig.split(",")) == len(argtypes) == 3
