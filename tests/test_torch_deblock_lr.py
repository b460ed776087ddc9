"""Deblock, Wiener LR and superres of av1dec_tpu_torch == av1dec_tpu's,
exactly, on edge maps and filter arguments from the committed streams
and on random ones (8- and 10-bit); and the device Wiener pass ==
`ops/spec/lr.lr_frame` (the spec model, which libaom matches) at a
1080p frame's restoration-unit and stripe geometry, where the JAX
package's pass is not: rows next to a unit-row boundary read the next
unit's rows, which must be filtered with their own output row's
taps."""
import numpy as np
import pytest
import torch

from torch_port_helpers import parse


def _smooth_plane(rng, H, W, bd, noise=3):
    """Gentle gradients + a little noise, so most deblock masks pass."""
    yy, xx = np.mgrid[:H, :W]
    base = (1 << (bd - 1)) + ((xx // 8 + yy // 8) % 3) * (6 << (bd - 8))
    return np.clip(base + rng.integers(-noise, noise + 1, (H, W)),
                   0, (1 << bd) - 1).astype(np.int32)


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
    from av1dec_tpu_torch.pipeline.device_recon import \
        _superres_dev as t_superres
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
