"""Deblock, Wiener LR and superres of av1dec_tpu_torch == av1dec_tpu's,
exactly, on edge maps and filter arguments from the committed streams
and on random ones (8- and 10-bit) and seeded maps that follow the
transform sizes (8, 10, 12 bits; on these no pixel has two writers in a
pass, on the random ones some do); and the device Wiener pass ==
`ops/spec/lr.lr_frame` (the spec model, which libaom matches) at a
1080p frame's restoration-unit and stripe geometry, where the JAX
package's pass is not: rows next to a unit-row boundary read the next
unit's rows, which must be filtered with their own output row's
taps.  (CPU tensors: the plain versions.)

The committed 1080p stream `bench_1080p_intra_lf` has a luma loop-filter
level in every frame, and `bench_1080p_intra_sres` superres in every
frame, coded 960 wide and upscaled to 1920 (their headers, parsed by the
port; tier-1 decodes no 1080p stream), so the card's main path runs
deblock and superres at 1080p.

Dispatch: `deblock_planes`, `lr_wiener_planes` and `superres_planes`
run the plain version on CPU tensors (no launch counted), raise on any
device but the CPU and a card, and their kernel wrappers raise on inputs
the kernels do not take before anything is launched.  On a card (`gpu`
marker): each kernel byte-equal to its plain version on the card, on
seeded 1080p frames, with its launches counted."""
import numpy as np
import pytest
import torch

from torch_port_helpers import parse
from torch_port_helpers import smooth_plane as _smooth_plane


def _run_both(planes, maps, sharp, bd):
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels.deblock import deblock_all
    from av1dec_tpu_torch.ops.kernels.deblock import deblock_planes
    jmaps = tuple(((jnp.asarray(fv), jnp.asarray(lv)),
                   (jnp.asarray(fh), jnp.asarray(lh)))
                  for (fv, lv), (fh, lh) in maps)
    ref = deblock_all(tuple(jnp.asarray(p) for p in planes), jmaps,
                      sharp, bd)
    tmaps = tuple(((torch.as_tensor(np.asarray(fv, np.int32)),
                    torch.as_tensor(np.asarray(lv, np.int32))),
                   (torch.as_tensor(np.asarray(fh, np.int32)),
                    torch.as_tensor(np.asarray(lh, np.int32))))
                  for (fv, lv), (fh, lh) in maps)
    got = deblock_planes(tuple(torch.as_tensor(p) for p in planes), tmaps,
                         sharp, bd)
    changed = 0
    for p, g, r in zip(planes, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        changed += int((g.numpy() != p).sum())
    assert changed > 0  # the filters did run


@pytest.mark.parametrize("name", ["odd", "mono", "tiles"])
def test_deblock_matches_jax_on_stream_maps(name, native_lib):
    from av1dec_tpu.ops.spec.deblock import build_deblock_maps
    from av1dec_tpu.pipeline.wavefront import Schedule
    seq, hdr, plans = parse(name, "jax")[0]
    sch = Schedule(seq, hdr, plans)
    maps = build_deblock_maps(seq, hdr, plans, sch.num_planes)
    assert maps is not None
    rng = np.random.default_rng(1)
    planes = [_smooth_plane(rng, h, w, sch.bd) for h, w in sch.valid_dims]
    _run_both(planes, maps, int(hdr["lf"]["sharpness"]), sch.bd)


def test_lf_stream_has_a_luma_loop_filter_level_in_every_frame(native_lib):
    from av1dec_tpu_torch.bindings import NativeParser
    from torch_port_helpers import manifest, tus
    p = NativeParser()
    levels = [hdr["lf"]["level"] for tu in tus("bench_1080p_intra_lf")
              for hdr in p.parse_tu(tu)]
    p.close()
    assert len(levels) == len(manifest()["bench_1080p_intra_lf"]["frames"])
    assert len(levels) == 8
    assert all(lv[0] > 0 and lv[1] > 0 for lv in levels), levels


def test_sres_stream_signals_superres_in_every_frame(native_lib):
    from av1dec_tpu_torch.bindings import NativeParser
    from torch_port_helpers import manifest, tus
    p = NativeParser()
    hdrs = [hdr for tu in tus("bench_1080p_intra_sres")
            for hdr in p.parse_tu(tu)]
    p.close()
    assert len(hdrs) == len(manifest()["bench_1080p_intra_sres"]["frames"])
    assert len(hdrs) == 8
    assert all(h["use_superres"] and h["frame_width"] == 960 and
               h["upscaled_width"] == 1920 and h["frame_height"] == 1080
               for h in hdrs), hdrs


@pytest.mark.parametrize("bd,sharp", [(8, 0), (8, 5), (10, 2)])
def test_deblock_matches_jax_on_random_maps(bd, sharp):
    rng = np.random.default_rng(bd + sharp)
    H, W = 40, 52   # W not a multiple of 4*8: ragged lattice edge

    def maps_for(h, w):
        def cell(n4, k4):
            flen = rng.choice([0, 4, 6, 8, 14], (n4, k4)).astype(np.int32)
            lvl = rng.integers(0, 64, (n4, k4)).astype(np.int32)
            return flen, lvl
        return (cell(-(-h // 4), -(-w // 4)), cell(-(-w // 4), -(-h // 4)))

    planes = [_smooth_plane(rng, H, W, bd, noise=6),
              _smooth_plane(rng, H // 2, W // 2, bd, noise=6)]
    _run_both(planes, [maps_for(H, W), maps_for(H // 2, W // 2)], sharp, bd)


@pytest.mark.parametrize("fmt,bd,sharp", [("420", 8, 0), ("444", 10, 3),
                                           ("422", 12, 7)])
def test_deblock_matches_jax_on_transform_size_maps(fmt, bd, sharp):
    from torch_port_helpers import seeded_deblock
    rng = np.random.default_rng(bd + sharp)
    _, planes, maps = seeded_deblock(rng, 44, 76, fmt, bd, "tx")
    _run_both([p.copy() for p in planes], maps, sharp, bd)


def _most_writers(planes, maps, sharp, bd):
    """The most edges whose filters write one pixel in a pass of
    `_deblock_plain` (the writers `_pass_axis1` recombines)."""
    from av1dec_tpu_torch.ops.kernels import deblock
    real, most = deblock._filter_edges, []

    def at(m, n):   # the writer n lattice steps to the right, at k
        z = torch.zeros_like(m[:, :1]).expand(-1, abs(n))
        return torch.cat([m[:, n:], z], 1) if n > 0 else \
            torch.cat([z, m[:, :n]], 1)

    def count(p, q, length, *rest):
        out = real(p, q, length, *rest)
        wp, wq = out[2], out[3]
        for j in range(4):
            other = at(wq[4 + j], -1) if j < 2 else at(wp[7 - j], 2)
            most.append(int((wq[j].int() + at(wp[3 - j], 1).int() +
                             other.int()).max()))
        return out
    deblock._filter_edges = count
    try:
        deblock._deblock_plain(planes, maps, sharp, bd)
    finally:
        deblock._filter_edges = real
    return max(most)


@pytest.mark.parametrize("fmt", ["420", "444", "mono"])
def test_transform_size_maps_give_each_pixel_one_writer(fmt):
    """The "tx" maps are as a stream's: no pixel has two writers in a
    pass.  The stress maps have pixels with several, whose order the
    kernel keeps."""
    from torch_port_helpers import seeded_deblock
    rng = np.random.default_rng(5)

    def writers(kind):
        _, planes, maps = seeded_deblock(rng, 48, 96, fmt, 8, kind)
        maps = tuple(tuple(tuple(torch.as_tensor(m) for m in pair)
                           for pair in pm) for pm in maps)
        return _most_writers(tuple(torch.as_tensor(p.copy())
                                   for p in planes), maps, 0, 8)
    assert writers("tx") == 1
    assert writers("fit") > 1


@pytest.mark.parametrize("name", ["lr", "sres_lr"])
def test_wiener_matches_jax(name, native_lib):
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels.lr import lr_wiener_planes as jwiener
    from av1dec_tpu.pipeline.device_recon import DeviceRecon
    from av1dec_tpu_torch.ops.kernels.lr import lr_wiener_planes as twiener
    seq, hdr, plans = parse(name, "jax")[0]
    dr = DeviceRecon(seq, hdr, plans)
    args = dr._lr_wiener_args()
    assert args is not None and any(a is not None for a in args)
    rng = np.random.default_rng(4)
    shapes = [(a[0].shape[0], a[1].shape[0]) if a is not None else (8, 8)
              for a in args]
    cdef_p = [_smooth_plane(rng, h, w, 8, noise=20) for h, w in shapes]
    pre_p = [_smooth_plane(rng, h, w, 8, noise=20) for h, w in shapes]
    ref = jwiener([jnp.asarray(p) for p in cdef_p],
                  [jnp.asarray(p) for p in pre_p],
                  [None if a is None else tuple(jnp.asarray(x) for x in a)
                   for a in args], 8)
    got = twiener([torch.as_tensor(p) for p in cdef_p],
                  [torch.as_tensor(p) for p in pre_p],
                  [None if a is None else tuple(torch.as_tensor(x)
                                                for x in a)
                   for a in args], 8)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("bd", [8, 10])
def test_superres_matches_jax(bd, native_lib):
    import jax.numpy as jnp
    from av1dec_tpu.pipeline.device_recon import DeviceRecon, _superres_dev
    from av1dec_tpu_torch.ops.kernels.superres import \
        superres_planes as t_superres
    seq, hdr, plans = parse("sres", "jax")[0]
    dr = DeviceRecon(seq, hdr, plans)
    args = dr._superres_args()
    rng = np.random.default_rng(bd)
    planes = [rng.integers(0, 1 << bd, (h, w)).astype(np.int32)
              for h, w in dr.sch.valid_dims]
    ref = _superres_dev([jnp.asarray(p) for p in planes],
                        [(jnp.asarray(c), jnp.asarray(t)) for c, t in args],
                        bd)
    got = t_superres([torch.as_tensor(p) for p in planes],
                     [(torch.as_tensor(c), torch.as_tensor(t))
                      for c, t in args], bd)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("plane", [0, 1, 2])
def test_wiener_matches_lr_frame_at_1080p_unit_rows(plane):
    """Synthetic planes and per-unit taps (some units off) on the
    geometry of `bench_1080p_host_cq40`'s key frame (1920x1080 4:2:0,
    luma units of 256, chroma units of 128: unit rows, and stripe
    boundaries, at chroma rows 124, 252 and 380)."""
    import types

    from av1dec_tpu_torch.ops.kernels.lr import wiener_plane
    from av1dec_tpu_torch.ops.spec import lr as L
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    W, H = 1920, 1080
    sizes = [256, 128, 128]
    rng = np.random.default_rng(40 + plane)
    sub = 1 if plane else 0
    pw, ph = (W + sub) >> sub, (H + sub) >> sub
    us = sizes[plane]
    frt = [0, 0, 0]
    frt[plane] = L.RESTORE_WIENER
    hdr = {"lr": {"frame_restoration_type": frt,
                  "loop_restoration_size": sizes},
           "upscaled_width": W, "frame_width": W, "frame_height": H}
    recs = []
    for ur in range(L._count_units(us, ph)):
        for uc in range(L._count_units(us, pw)):
            on = L.RESTORE_WIENER if rng.random() < 0.8 else L.RESTORE_NONE
            taps = rng.integers(-5, 10, 6)
            recs.append([plane, ur, uc, on, *taps.tolist(), 0, 0, 0])
    plans = types.SimpleNamespace(lr=np.asarray(recs, np.int64))
    sch = types.SimpleNamespace(num_planes=3, sub_x=1, sub_y=1,
                                valid_dims=[(H, W), (ph, pw), (ph, pw)])
    args = DeviceRecon._lr_wiener_args(
        types.SimpleNamespace(hdr=hdr, sch=sch, plans=plans))[plane]
    cdef_p = _smooth_plane(rng, ph, pw, 8, noise=40)
    pre_p = _smooth_plane(rng, ph, pw, 8, noise=40)
    got = wiener_plane(torch.as_tensor(cdef_p), torch.as_tensor(pre_p),
                       tuple(torch.as_tensor(a) for a in args), 8).numpy()
    shapes = [(H, W), (ph, pw), (ph, pw)]
    planes = [np.zeros(s, np.int64) for s in shapes]
    pres = [np.zeros(s, np.int64) for s in shapes]
    planes[plane], pres[plane] = cdef_p.astype(np.int64), \
        pre_p.astype(np.int64)
    want = L.lr_frame(planes, pres, {"subsampling_x": 1,
                                     "subsampling_y": 1},
                      hdr, plans, 8)[plane]
    np.testing.assert_array_equal(got, want)
    assert (got != cdef_p).any()


def _seeded(kind, dev, bd=8, fmt="420", H=40, W=52):
    """(dispatcher, plain version, kernel module, args) of one kernel on
    seeded inputs on `dev`."""
    from av1dec_tpu_torch.ops.kernels import deblock, lr, superres
    from torch_port_helpers import (seeded_deblock, seeded_wiener_args,
                                    superres_case)
    rng = np.random.default_rng(11)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    if kind == "deblock":
        _, planes, maps = seeded_deblock(rng, H, W, fmt, bd)
        maps = tuple(tuple(tuple(t(m) for m in pair) for pair in pm)
                     for pm in maps)
        return (deblock.deblock_planes, deblock._deblock_plain, deblock,
                (tuple(t(p) for p in planes), maps, 3, bd))
    if kind == "wiener":
        cdef_p, pre_p, args = [], [], []
        for plane in range(3):
            a, _, _ = seeded_wiener_args(rng, W, H, [64, 32, 32], plane)
            h, w = len(a[0]), len(a[1])
            cdef_p.append(t(_smooth_plane(rng, h, w, bd, 20 << (bd - 8))))
            pre_p.append(t(_smooth_plane(rng, h, w, bd, 20 << (bd - 8))))
            args.append(tuple(t(x) for x in a))
        return lr.lr_wiener_planes, lr._wiener_plain, lr, \
            (cdef_p, pre_p, args, bd)
    planes, args = superres_case(rng, W, H, 9, fmt, bd)
    return (superres.superres_planes, superres._superres_plain, superres,
            ([t(p) for p in planes], [tuple(t(x) for x in a)
                                      for a in args], bd))


KINDS = ["deblock", "wiener", "superres"]


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_tensors_run_the_plain_version(kind):
    fn, plain, mod, args = _seeded(kind, "cpu")
    before = mod.launches
    got, want = fn(*args), plain(*args)
    assert mod.launches == before and len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _on_meta(a):
    if torch.is_tensor(a):
        return a.to("meta")
    if isinstance(a, (list, tuple)):
        return type(a)(_on_meta(x) for x in a)
    return a


@pytest.mark.parametrize("kind", KINDS)
def test_other_devices_raise(kind):
    fn, _, mod, args = _seeded(kind, "cpu")
    with pytest.raises(ValueError, match="unsupported device meta"):
        fn(*_on_meta(args))


def test_deblock_kernel_refuses_inputs_it_does_not_take():
    from av1dec_tpu_torch.ops.kernels import deblock
    _, _, _, (planes, maps, sharp, bd) = _seeded("deblock", "cpu")
    wide = torch.zeros(planes[0].shape[0], 2 * planes[0].shape[1],
                       dtype=torch.int32)
    for args, match in (
            ((planes, maps, sharp, 9), "bits"),
            ((planes, maps, 8, bd), "sharpness"),
            ((planes * 2, maps * 2, sharp, bd), "planes"),
            ((planes, maps[:2], sharp, bd), "maps"),
            ((tuple(p.to(torch.int16) for p in planes), maps, sharp, bd),
             "int32"),
            (((wide[:, ::2],) + planes[1:], maps, sharp, bd), "rows"),
            ((planes, ((maps[0][0], (maps[0][1][0].T, maps[0][1][1])),)
              + maps[1:], sharp, bd), "contiguous")):
        before = deblock.launches
        with pytest.raises(ValueError, match=match):
            deblock._deblock_kernel(*args)
        assert deblock.launches == before


def test_wiener_kernel_refuses_inputs_it_does_not_take():
    from av1dec_tpu_torch.ops.kernels import lr
    _, _, _, (cdef_p, pre_p, args, bd) = _seeded("wiener", "cpu")
    bad_act = (args[0][:4] + (args[0][4].bool(),) + args[0][5:],) + \
        tuple(args[1:])
    short_vr = (args[0][:5] + (args[0][5][:, 1:].contiguous(),) +
                args[0][6:],) + tuple(args[1:])
    for a, match in (
            ((cdef_p, pre_p, args, 9), "bits"),
            (([p.to(torch.int16) for p in cdef_p], pre_p, args, bd),
             "int32"),
            ((cdef_p, pre_p[:1] + [pre_p[1][1:]] + pre_p[2:], args, bd),
             "pre-CDEF"),
            ((cdef_p, pre_p, bad_act, bd), "act"),
            ((cdef_p, pre_p, short_vr, bd), "vr")):
        before = lr.launches
        with pytest.raises(ValueError, match=match):
            lr._wiener_kernel(*a)
        assert lr.launches == before
    # no plane with arguments: nothing to launch
    assert lr._wiener_kernel(cdef_p, pre_p, [None] * 3, bd) == cdef_p


def test_superres_kernel_refuses_inputs_it_does_not_take():
    from av1dec_tpu_torch.ops.kernels import superres
    _, _, _, (planes, args, bd) = _seeded("superres", "cpu")
    for a, match in (
            ((planes, args, 7), "bits"),
            ((planes * 3, args * 3, bd), "planes"),
            (([p.to(torch.uint8) for p in planes], args, bd), "int32"),
            ((planes, [(c, t[:, :4].contiguous()) for c, t in args], bd),
             "cols and taps"),
            ((planes, [(c.long(), t) for c, t in args], bd),
             "cols and taps")):
        before = superres.launches
        with pytest.raises(ValueError, match=match):
            superres._superres_kernel(*a)
        assert superres.launches == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run with `pytest -m gpu` on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cuda_kernel_matches_plain_at_1080p(kind, bd):
    _need_card()
    fn, plain, mod, args = _seeded(kind, "cuda", bd, "420", 1080, 1920)
    want = plain(*args)
    for _ in range(3):
        before = mod.launches
        got = fn(*args)
        assert mod.launches == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cuda_deblock_matches_plain_on_transform_size_maps(bd):
    _need_card()
    from av1dec_tpu_torch.ops.kernels import deblock
    from torch_port_helpers import seeded_deblock
    rng = np.random.default_rng(bd)
    _, planes, maps = seeded_deblock(rng, 1080, 1920, "420", bd, "tx")
    args = (tuple(torch.as_tensor(p.copy(), device="cuda") for p in planes),
            tuple(tuple(tuple(torch.as_tensor(m, device="cuda")
                              for m in pair) for pair in pm) for pm in maps),
            0, bd)
    for g, w in zip(deblock.deblock_planes(*args),
                    deblock._deblock_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["422", "444", "mono"])
def test_cuda_deblock_matches_plain_in_every_format(fmt):
    _need_card()
    for bd in (8, 10, 12):
        fn, plain, _, args = _seeded("deblock", "cuda", bd, fmt, 61, 83)
        for g, w in zip(fn(*args), plain(*args)):
            assert torch.equal(g, w)
