"""The frozen bytes-and-operations arithmetic of `pbcore/work.py` gives
the counts of the port's `chip_smoke.py` (`*_work`), on the arguments
that CPU decodes of small committed streams hand each kernel's wrapper,
and on seeded ones; and the bound's peaks are the published ones."""
import numpy as np
import pytest
import torch

from pbcore import drive, spec, work

# streams whose CPU decode reaches every wrapper: CDEF and the scan
# (all), deblock, superres (sres), Wiener (lr), MC (lowdelay), the host
# path's residuals (obmc)
STREAMS = ("multi", "sres", "lowdelay", "obmc")
TESTDATA = ("lr", "cdef_mid", "sres_lr")


@pytest.fixture(scope="module")
def captured():
    """Each wrapper's calls' arguments (and outputs) on the CPU."""
    import os
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.pipeline import device_recon, recon
    got = {k: [] for k in ("scan", "mc", "itx", "deblock", "superres",
                           "wiener", "cdef")}
    real = {}

    def keep(owner, name, key, with_out=False):
        fn = owner.__dict__[name]
        real[(owner, name)] = fn

        def wrapped(*args):
            out = fn(*args)
            got[key].append((args, out) if with_out else args)
            return out
        setattr(owner, name, wrapped)
    keep(device_recon, "scan_into", "scan")
    keep(device_recon, "mc_into", "mc")
    keep(recon, "residuals_packed", "itx")
    keep(device_recon, "deblock_planes", "deblock")
    keep(device_recon, "superres_planes", "superres", True)
    keep(device_recon, "lr_wiener_planes", "wiener")
    keep(cdef, "cdef_frame", "cdef")
    paths = [spec.stream_path(s) for s in STREAMS] + [
        os.path.join(spec.ROOT, "av1dec_tpu_torch", "testdata", s + ".ivf")
        for s in TESTDATA]
    try:
        for p in paths:
            dec = api.Decoder(device="cpu")
            for tu in drive.read_ivf(p):
                dec.decode(tu)
            dec.close()
    finally:
        for (owner, name), fn in real.items():
            setattr(owner, name, fn)
    for k, v in got.items():
        assert v, f"no {k} call captured"
    return got


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke
    return chip_smoke


def test_peaks_and_tables(smoke):
    from av1dec_tpu_torch.ops.spec import itx as S
    assert work.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert work.INT8_OPS_PER_S == smoke.INT8_OPS_PER_S
    assert work.INT32_OPS_PER_S == 64 * 132 * 1980e6
    for k in ("CDEF_OPS_PER_TAP", "CDEF_OPS_PER_PX", "DIR_OPS_PER_UNIT",
              "DIR_INT8_OPS_PER_UNIT", "SCAN_OPS_PER_PX", "SCAN_FAMILY_OPS",
              "SCAN_CFL_OPS_PER_PX", "DEBLOCK_DECISION_OPS", "DEBLOCK_OPS",
              "SEP_OPS_PER_PX", "SUPERRES_OPS_PER_PX"):
        assert getattr(work, k) == getattr(smoke, k), k
    assert [tuple(d) for d in S.TX_DIMS] == work.TX_DIMS
    assert {t: v[:2] for t, v in S.TX_1D.items()} == work.TX_KINDS
    for (kind, n), ops in work.TRANSFORM_OPS.items():
        assert smoke.transform_ops(kind, n) == ops
    b = smoke.bound_terms(work.INT32_OPS_PER_S, 1e9, 3e9, 1e9)
    assert work.bound_s(1e9, 3e9, 1e9) * 1e3 == pytest.approx(b["bound_ms"])


def test_scan_and_mc(captured, smoke):
    for args in captured["scan"]:
        frame, packed, res, pal, config, windows, levels = args
        want = smoke.scan_work({"packed": packed, "res": res,
                                "config": config})
        assert work.scan_work(packed, res, config) == want[:2]
    for frame, ref_flat, lanes, cfg in captured["mc"]:
        assert work.mc_work(ref_flat, lanes, cfg) == \
            smoke.mc_work(ref_flat, lanes, cfg)[:2]


def test_residuals(captured, smoke):
    for buf, spans, words, bd in captured["itx"]:
        assert work.residual_work(buf, spans) == \
            smoke.residual_work(buf.numpy(), spans)[:2]


def test_postfilter(captured, smoke):
    for planes, maps, sharp, bd in captured["deblock"]:
        assert work.deblock_work(planes, maps, sharp, bd) == \
            smoke.deblock_work(planes, maps, sharp, bd)[:2]
    for (planes, sr_args, bd), out in captured["superres"]:
        assert work.superres_work(planes, sr_args, out) == \
            smoke.superres_work(planes, sr_args, out)
    for planes, pre, lr_args, bd in captured["wiener"]:
        assert work.wiener_work(planes, pre, lr_args) == \
            smoke.wiener_work(planes, pre, lr_args)


def test_cdef_on_streams_and_seeded(captured, smoke):
    for planes, yp, ys, up, us, bd, damping, sx, sy in captured["cdef"]:
        gates = (yp, ys, up, us)
        assert work.cdef_work(planes, gates, bd, sx, sy) == \
            smoke.cdef_work(planes, gates, bd, sx, sy)
    rng = np.random.default_rng(5)
    for bd in (8, 10):
        H, W = 64, 96
        luma = torch.as_tensor(rng.integers(0, 1 << bd, (H, W)),
                               dtype=torch.int32)
        chroma = [torch.as_tensor(rng.integers(0, 1 << bd, (H // 2, W // 2)),
                                  dtype=torch.int32) for _ in range(2)]
        gates = tuple(torch.as_tensor(rng.integers(0, 16, (H // 8, W // 8)),
                                      dtype=torch.int32) for _ in range(4))
        planes = (luma, *chroma)
        assert work.cdef_work(planes, gates, bd, 1, 1) == \
            smoke.cdef_work(planes, gates, bd, 1, 1)


def test_residuals_seeded(smoke):
    from av1dec_tpu_torch.ops.kernels import itx
    rng = np.random.default_rng(3)
    buckets = []
    for tsz, tt in itx.valid_transforms():
        w, h = work.TX_DIMS[tsz]
        m = min(w, 32) * min(h, 32)
        levels = rng.integers(-50, 51, (3, m)).astype(np.int32)
        q = np.full(3, 40, np.int32)
        buckets.append((levels, q, q, tsz, tt))
    buf, spans, words = itx.pack_buckets(buckets)
    assert work.residual_work(torch.as_tensor(buf), spans) == \
        smoke.residual_work(buf, spans)[:2]


def test_lane_layouts_are_the_programs():
    """The frozen lane-row columns are the program's; a program whose
    columns differ gets no bound at all."""
    from av1dec_tpu_torch.ops.kernels import mc
    for name, (frozen, now) in work.program_layouts().items():
        assert frozen == now, name
    work.check_layouts()
    real = mc.MC_FIELDS
    mc.MC_FIELDS = list(real[::-1])
    try:
        with pytest.raises(work.LayoutChanged):
            with work.Recorder():
                pass
    finally:
        mc.MC_FIELDS = real


def _deblock_maps(rng, H, W, lengths):
    def cells(h, w):
        return (torch.as_tensor(rng.choice(lengths, (h, w)),
                                dtype=torch.int32),
                torch.as_tensor(rng.integers(0, 64, (h, w)),
                                dtype=torch.int32))
    return (cells(-(-H // 4), -(-W // 4)), cells(-(-W // 4), -(-H // 4)))


@pytest.mark.parametrize("bd", [8, 10])
def test_frozen_deblock_is_the_programs_plain(captured, bd):
    """The frozen plain deblock filters as the program's plain version:
    on the streams' calls and on seeded near-flat planes, where every
    filter kind runs."""
    from av1dec_tpu_torch.ops.kernels import deblock
    calls = [a for a in captured["deblock"] if a[3] == bd]
    rng = np.random.default_rng(bd)
    for H, W, sub in ((64, 96, 0), (37, 53, 1)):
        planes, maps = [], []
        for i in range(3):
            h, w = (H, W) if i == 0 else ((H + sub) >> sub, (W + sub) >> sub)
            # noise within the flatness threshold in some 8x8 cells,
            # three times it in others
            F = 1 << (bd - 8)
            amp = np.kron(rng.choice([1, 3], (h // 8 + 1, w // 8 + 1)),
                          np.ones((8, 8), np.int64))[:h, :w]
            base = rng.integers(16 << (bd - 8), 200 << (bd - 8))
            planes.append(torch.as_tensor(
                base + rng.integers(0, F + 1, (h, w)) * amp,
                dtype=torch.int32))
            maps.append(_deblock_maps(rng, h, w, [0, 4, 6, 8, 14] if i == 0
                                      else [0, 4, 6]))
        calls.append((tuple(planes), tuple(maps), int(rng.integers(0, 8)),
                      bd))
    kinds = dict.fromkeys(("wide", "8", "6", "4"), 0)
    for planes, maps, sharp, b in calls:
        want = deblock._deblock_plain(planes, maps, sharp, b)
        got, seen = work.deblock_plain.deblock(planes, maps, sharp, b)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for k in kinds:
            kinds[k] += seen[k]
    assert all(kinds.values()), kinds
