"""CDEF of av1dec_tpu_torch == av1dec_tpu's, exactly: the direction
search (with ties), the plain plane filter at the Pallas test's shapes
(8- and 10-bit), the whole-frame core, the column-shard CDEF
`cdef_shard` (its CPU route, cut into 1, 2 and 4 shards, and with
random halo columns), its argument checks, and — on a card — the shard
kernel against its plain version."""
import numpy as np
import pytest
import torch

SHAPES = [(64, 64), (40, 72), (24, 128)]


def _maps(rng, H, W, bd, damping=5):
    """Random plane + per-8x8-unit maps (primary and secondary, all 8
    directions) as int32 numpy arrays (test_pallas_cdef's recipe)."""
    cs = bd - 8
    uH, uW = (H + 7) // 8, (W + 7) // 8

    def expand(u):
        return np.repeat(np.repeat(u, 8, 0), 8, 1)[:H, :W].astype(np.int32)

    def shift_for(s, d):
        return np.maximum(0, d - np.int64(np.floor(np.log2(
            np.maximum(s, 1)))))

    plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    pri_u = rng.integers(0, 16, (uH, uW)) << cs
    sec_u = rng.choice([0, 1, 2, 4], (uH, uW)) << cs
    dir_u = rng.integers(0, 8, (uH, uW))
    maps = [expand(pri_u), expand(sec_u), expand(dir_u),
            expand(shift_for(pri_u, damping + cs)),
            expand(shift_for(sec_u, damping + cs)),
            expand((pri_u > 0) | (sec_u > 0))]
    return plane, maps, cs


@pytest.mark.parametrize("bd", [8, 10])
def test_directions_match_jax_with_ties(bd):
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels import cdef as J
    from av1dec_tpu_torch.ops.kernels import cdef as T
    rng = np.random.default_rng(11)
    H, W = 64, 96
    luma = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    # tie-makers: flat blocks (every cost 0), a checkerboard, a ramp
    # along each axis, and strong single-direction stripes
    luma[:8, :8] = 77 << (bd - 8)
    luma[:8, 8:16] = ((np.indices((8, 8)).sum(0) % 2) * 200) << (bd - 8)
    luma[8:16, :8] = (np.arange(8)[None, :] * 30) << (bd - 8)
    luma[8:16, 8:16] = (np.arange(8)[:, None] * 30) << (bd - 8)
    luma[16:24, :8] = ((np.indices((8, 8)).sum(0) % 3) * 100) << (bd - 8)
    jd, jv = J._directions(jnp.asarray(luma), bd)
    td, tv = T._directions(torch.as_tensor(luma), bd)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert td.dtype == torch.int32 and tv.dtype == torch.int32
    assert int(td[0, 0]) == 0  # all-equal costs: the first direction


def test_first_argmax_takes_lowest_index():
    from av1dec_tpu_torch.ops.kernels.cdef import _first_argmax
    cost = torch.tensor([[5, 9, 9, 1, 9, 0, 0, 0],
                         [0, 0, 0, 0, 0, 0, 0, 0],
                         [1, 2, 3, 4, 5, 6, 7, 7]], dtype=torch.int64)
    assert _first_argmax(cost).tolist() == [1, 0, 6]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bd", [8, 10])
def test_filter_plane_matches_jax(shape, bd):
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels import cdef as J
    from av1dec_tpu_torch.ops.kernels import cdef as T
    rng = np.random.default_rng(7)
    plane, maps, cs = _maps(rng, *shape, bd)
    ref = np.asarray(J._filter_plane(jnp.asarray(plane),
                                     *[jnp.asarray(m) for m in maps], cs))
    args = [torch.as_tensor(plane)] + [torch.as_tensor(m) for m in maps]
    got = T._filter_plane(*args, cs)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("interior", ["plane", "random"])
def test_filter_plane_with_caller_pad_matches_jax(interior):
    """A caller's pad feeds every tap; the centre pixel comes from the
    plane (a random interior tells the two apart)."""
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels import cdef as J
    from av1dec_tpu_torch.ops.kernels import cdef as T
    rng = np.random.default_rng(3)
    plane, maps, cs = _maps(rng, 32, 48, 8)
    pad = rng.integers(0, 256, (36, 52)).astype(np.int32)
    if interior == "plane":
        pad[2:34, 2:50] = plane
    ref = np.asarray(J._filter_plane(
        jnp.asarray(plane), *[jnp.asarray(m) for m in maps], cs,
        pad=jnp.asarray(pad)))
    got = T._filter_plane(torch.as_tensor(plane),
                          *[torch.as_tensor(m) for m in maps], cs,
                          pad=torch.as_tensor(pad))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_filter_plane_rejects_other_devices():
    """The public CDEF filter of a plane's bordered copy, `cdef_shard`
    (which replaced the per-plane `filter_plane`; the name is kept),
    refuses a device that is neither the CPU nor a card."""
    from av1dec_tpu_torch.ops.kernels import cdef as T
    pad = torch.zeros((12, 12), dtype=torch.int32, device="meta")
    g = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        T.cdef_shard((pad,), g, g, g, g, 8, 3, 0, 0)


@pytest.mark.parametrize("fault", ["device", "dtype", "shape",
                                   "contiguity", "strength", "planes"])
def test_cdef_shard_rejects_bad_inputs(fault):
    """`cdef_shard` checks every tensor before it runs either route: the
    pads and the strengths on one device, int32, of the shard's shapes,
    contiguous, and 1 or 3 planes."""
    from av1dec_tpu_torch.ops.kernels import cdef as T
    H, W = 16, 24
    pads = [torch.zeros((H + 4, W + 4), dtype=torch.int32)] + \
        [torch.zeros((H // 2 + 4, W // 2 + 4), dtype=torch.int32)] * 2
    gates = [torch.zeros((H // 8, W // 8), dtype=torch.int32)
             for _ in range(4)]
    if fault == "device":
        pads[1] = pads[1].to("meta")
    elif fault == "dtype":
        pads[2] = pads[2].to(torch.int64)
    elif fault == "shape":
        pads[1] = torch.zeros((H + 4, W + 4), dtype=torch.int32)
    elif fault == "contiguity":
        pads[0] = torch.zeros((W + 4, H + 4), dtype=torch.int32).t()
    elif fault == "strength":
        gates[3] = torch.zeros((H // 8, W // 8 + 1), dtype=torch.int32)
    else:
        pads = pads[:2]
    with pytest.raises(ValueError):
        T.cdef_shard(tuple(pads), *gates, 8, 4, 1, 1)


# (planes H x W, bd, subx, suby): 4:2:0, 4:2:2 (direction remap), 4:4:4,
# mono, 10-bit
FRAMES = [((64, 96), 8, 1, 1), ((48, 64), 8, 1, 0), ((40, 48), 8, 0, 0),
          ((48, 64), 8, None, None), ((64, 64), 10, 1, 1)]


def _frame(geom, bd, subx, suby):
    """Random planes and gated strengths of a frame, as int32 numpy
    arrays, from a seed of the geometry: (planes, gates, damping, subx,
    suby), subx = suby = 0 for mono (subx None)."""
    rng = np.random.default_rng(sum(geom) + bd)
    H, W = geom
    cs = bd - 8
    planes = [rng.integers(0, 1 << bd, (H, W)).astype(np.int32)]
    if subx is not None:
        for _ in range(2):
            planes.append(rng.integers(
                0, 1 << bd, (H >> suby, W >> subx)).astype(np.int32))
    uH, uW = H // 8, W // 8

    def gate(choices):
        u = rng.choice(choices, (uH, uW)) << cs
        return np.where(rng.random((uH, uW)) < 0.8, u, 0).astype(np.int32)

    gates = [gate(np.arange(16)), gate([0, 1, 2, 4]),
             gate(np.arange(16)), gate([0, 1, 2, 4])]
    return planes, gates, 4 + cs, subx or 0, suby or 0


_JAX_WHOLE = {}


def _jax_cdef_all(geom, bd, subx, suby):
    """JAX `_cdef_all` of `_frame(...)` (computed once per frame)."""
    key = (geom, bd, subx, suby)
    if key not in _JAX_WHOLE:
        import jax.numpy as jnp
        from av1dec_tpu.ops.kernels import cdef as J
        planes, gates, damping, sx, sy = _frame(geom, bd, subx, suby)
        _JAX_WHOLE[key] = [np.asarray(r) for r in J._cdef_all(
            tuple(jnp.asarray(p) for p in planes),
            *[jnp.asarray(g) for g in gates], bd, damping, sx, sy)]
    return _JAX_WHOLE[key]


@pytest.mark.parametrize("geom,bd,subx,suby", FRAMES)
def test_cdef_core_matches_jax_cdef_all(geom, bd, subx, suby):
    from av1dec_tpu_torch.ops.kernels import cdef as T
    planes, gates, damping, sx, sy = _frame(geom, bd, subx, suby)
    ref = _jax_cdef_all(geom, bd, subx, suby)
    got = T._cdef_core(tuple(torch.as_tensor(p) for p in planes),
                       *[torch.as_tensor(g) for g in gates], bd, damping,
                       sx, sy)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def _shard_args(planes, gates, n, s):
    """`cdef_shard`'s arguments for column shard s of n of a whole frame
    (torch int32): the bordered planes as `cdef_local` builds them
    (`_local_pad`) and the shard's strengths."""
    from av1dec_tpu_torch.parallel.sharded_cdef import _local_pad
    pads = tuple(_local_pad(torch.as_tensor(p), s, n) for p in planes)
    uw = gates[0].shape[1] // n
    strengths = [torch.as_tensor(g[:, s * uw:(s + 1) * uw]).contiguous()
                 for g in gates]
    return pads, strengths


# FRAMES' geometries at 8 and 10 bits, cut into the shard counts that
# split their width into whole 8x8 units
SHARDED = [(geom, bd, subx, suby, n)
           for geom, _, subx, suby in FRAMES for bd in (8, 10)
           for n in (1, 2, 4) if (geom[1] // 8) % n == 0]


@pytest.mark.parametrize("geom,bd,subx,suby,n", SHARDED)
def test_cdef_shard_matches_jax_cdef_all(geom, bd, subx, suby, n):
    """`cdef_shard`'s CPU route on each of n column shards, with the
    bordered planes of `_local_pad`, gives the JAX whole-frame CDEF's
    columns of that shard."""
    from av1dec_tpu_torch.ops.kernels import cdef as T
    planes, gates, damping, sx, sy = _frame(geom, bd, subx, suby)
    ref = _jax_cdef_all(geom, bd, subx, suby)
    before = T.launches
    for s in range(n):
        pads, strengths = _shard_args(planes, gates, n, s)
        got = T.cdef_shard(pads, *strengths, bd, damping, sx, sy)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            w = r.shape[1] // n
            np.testing.assert_array_equal(g.numpy(),
                                          r[:, s * w:(s + 1) * w])
    assert T.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("geom,subx,suby", [(g, sx, sy)
                                            for g, _, sx, sy in FRAMES[:4]])
def test_cdef_shard_random_halos_match_core_and_jax(geom, subx, suby, bd):
    """Random values in every pad's halo columns (not the frame's
    neighbouring pixels, nor CDEF_VERY_LARGE): `cdef_shard` equals
    `_cdef_core` with those pads and the JAX `_cdef_core`, whose
    `_filter_plane` reads each plane's taps from the same pad."""
    import jax
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels import cdef as J
    from av1dec_tpu_torch.ops.kernels import cdef as T
    planes, gates, damping, sx, sy = _frame(geom, bd, subx, suby)
    pads, strengths = _shard_args(planes, gates, 2, 1)
    rng = np.random.default_rng(bd)
    for p in pads:
        for cols in (slice(0, 2), slice(-2, None)):
            p[2:-2, cols] = torch.as_tensor(rng.integers(
                0, 1 << bd, (p.shape[0] - 4, 2)).astype(np.int32))
    got = T.cdef_shard(pads, *strengths, bd, damping, sx, sy)
    shards = tuple(p[2:-2, 2:-2] for p in pads)
    core = T._cdef_core(shards, *strengths, bd, damping, sx, sy, pads=pads)

    def jax_core(jshards, jgates, jpads):
        it = iter(jpads)
        return J._cdef_core(jshards, *jgates, bd, damping, sx, sy,
                            mk_pad=lambda _: next(it))
    ref = jax.jit(jax_core)(
        tuple(jnp.asarray(p.numpy()) for p in shards),
        [jnp.asarray(g.numpy()) for g in strengths],
        [jnp.asarray(p.numpy()) for p in pads])
    assert len(got) == len(core) == len(ref)
    for g, c, r in zip(got, core, ref):
        assert torch.equal(g, c)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the halos matter: the frame's own neighbours give another result
    plain, _ = _shard_args(planes, gates, 2, 1)
    assert any(not torch.equal(g, o) for g, o in zip(
        got, T.cdef_shard(plain, *strengths, bd, damping, sx, sy)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n", [(s, n) for s in SHAPES
                                     for n in (1, 2, 4)
                                     if (s[1] // 8) % n == 0] +
                         [((1080, 1920), 2), ((1080, 1920), 4)])
@pytest.mark.parametrize("bd", [8, 10])
def test_cuda_kernel_matches_plain(shape, n, bd):
    """The shard kernel (`cdef_shard` on the card, one launch a shard)
    == its plain version `_cdef_shard_core` on every shard of a 4:2:0
    frame, with random halo columns in the pads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run with `pytest -m gpu` on the card)")
    from av1dec_tpu_torch.ops.kernels import cdef as T
    planes, gates, damping, sx, sy = _frame(shape, bd, 1, 1)
    rng = np.random.default_rng(5)
    for s in range(n):
        pads, strengths = _shard_args(planes, gates, n, s)
        for p in pads:
            for cols in (slice(0, 2), slice(-2, None)):
                p[2:-2, cols] = torch.as_tensor(rng.integers(
                    0, 1 << bd, (p.shape[0] - 4, 2)).astype(np.int32))
        args = ([p.cuda() for p in pads],
                *[g.cuda() for g in strengths], bd, damping, sx, sy)
        before = T.launches
        got = T.cdef_shard(*args)
        assert T.launches == before + 1
        ref = T._cdef_shard_core(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
