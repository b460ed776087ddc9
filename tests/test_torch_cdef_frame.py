"""`cdef_frame` of av1dec_tpu_torch == av1dec_tpu's `_cdef_all`, exactly,
on the CPU (where it runs its plain version): every chroma format, 8- and
10-bit, a size that is a multiple of 8 but not of 64, strengths that are
all zero, primary only, secondary only or mixed, and luma blocks that
make direction ties.  On a card, the frame kernel against the plain
version."""
import numpy as np
import pytest
import torch

# (subx, suby) or None for mono
FORMATS = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "mono": None}
GATES = ["mixed", "zero", "pri_only", "sec_only"]


def _frame(seed, H, W, bd, fmt, gates):
    """Random planes (with tie-making luma blocks) and gated per-8x8-unit
    strengths, as numpy int32; returns (planes, gates, damping, subx,
    suby)."""
    rng = np.random.default_rng(seed)
    cs = bd - 8
    sub = FORMATS[fmt]
    luma = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    # tie-makers (test_torch_cdef's recipe): a flat block (every cost 0),
    # a checkerboard, a ramp along each axis, a period-3 pattern
    luma[:8, :8] = 77 << cs
    luma[:8, 8:16] = ((np.indices((8, 8)).sum(0) % 2) * 200) << cs
    luma[8:16, :8] = (np.arange(8)[None, :] * 30) << cs
    luma[8:16, 8:16] = (np.arange(8)[:, None] * 30) << cs
    luma[16:24, :8] = ((np.indices((8, 8)).sum(0) % 3) * 100) << cs
    planes = [luma]
    subx, suby = sub if sub else (0, 0)
    if sub:
        for _ in range(2):
            planes.append(rng.integers(
                0, 1 << bd, (H >> suby, W >> subx)).astype(np.int32))
    uH, uW = H // 8, W // 8

    def gate(choices, on):
        u = rng.choice(choices, (uH, uW)) << cs
        keep = rng.random((uH, uW)) < 0.8
        return np.where(keep & on, u, 0).astype(np.int32)

    pri_on = gates in ("mixed", "pri_only")
    sec_on = gates in ("mixed", "sec_only")
    g = [gate(np.arange(16), pri_on), gate([0, 1, 2, 4], sec_on),
         gate(np.arange(16), pri_on), gate([0, 1, 2, 4], sec_on)]
    damping = int(rng.integers(3, 7)) + cs
    return planes, g, damping, subx, suby


@pytest.mark.parametrize("gates", GATES)
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_cdef_frame_matches_jax_cdef_all(fmt, bd, gates):
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels import cdef as J
    from av1dec_tpu_torch.ops.kernels import cdef as T
    planes, g, damping, subx, suby = _frame(
        len(fmt) * 100 + bd + GATES.index(gates), 72, 136, bd, fmt, gates)
    ref = J._cdef_all(tuple(jnp.asarray(p) for p in planes),
                      *[jnp.asarray(x) for x in g], bd, damping, subx, suby)
    before = T.frame_launches
    got = T.cdef_frame(tuple(torch.as_tensor(p) for p in planes),
                       *[torch.as_tensor(x) for x in g], bd, damping, subx,
                       suby)
    assert T.frame_launches == before  # the CPU runs the plain version
    assert len(got) == len(ref) == len(planes)
    for a, r in zip(got, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    if gates == "zero":
        for a, p in zip(got, planes):
            np.testing.assert_array_equal(a.numpy(), p)


def test_cdef_frame_rejects_other_devices():
    from av1dec_tpu_torch.ops.kernels import cdef as T
    x = torch.zeros((8, 8), dtype=torch.int32, device="meta")
    u = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        T.cdef_frame((x,), u, u, u, u, 8, 3, 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (72, 136, fmt, bd, gates) for fmt in FORMATS for bd in (8, 10)
    for gates in GATES] + [(1080, 1920, "420", 8, "mixed"),
                           (1080, 1920, "420", 10, "mixed")])
def test_cuda_frame_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run with `pytest -m gpu` on the card)")
    from av1dec_tpu_torch.ops.kernels import cdef as T
    H, W, fmt, bd, gates = case
    planes, g, damping, subx, suby = _frame(H + W + bd, H, W, bd, fmt,
                                            gates)
    pl = tuple(torch.as_tensor(p, device="cuda") for p in planes)
    gd = [torch.as_tensor(x, device="cuda") for x in g]
    before = T.frame_launches
    got = T.cdef_frame(pl, *gd, bd, damping, subx, suby)
    assert T.frame_launches == before + 1
    ref = T._cdef_core(pl, *gd, bd, damping, subx, suby)
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_frame_kernel_takes_plane_views(offset):
    """Planes as row views of one flat buffer whose rows are wider than
    the planes, as the decoder's frame buffer holds them: at a 16-byte
    aligned offset the kernel reads the views in place, at offset 1 the
    wrapper copies them first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run with `pytest -m gpu` on the card)")
    from av1dec_tpu_torch.ops.kernels import cdef as T
    planes, g, damping, subx, suby = _frame(9, 72, 136, 8, "420", "mixed")
    pitches = (192, 96, 96)
    buf = torch.zeros(offset + sum(p.shape[0] * s
                                   for p, s in zip(planes, pitches)),
                      dtype=torch.int32, device="cuda")
    views, base = [], offset
    for p, pitch in zip(planes, pitches):
        h, w = p.shape
        v = buf[base: base + h * pitch].view(h, pitch)[:, :w]
        v.copy_(torch.as_tensor(p))
        views.append(v)
        base += h * pitch
    gd = [torch.as_tensor(x, device="cuda") for x in g]
    got = T.cdef_frame(tuple(views), *gd, 8, damping, subx, suby)
    ref = T._cdef_core(tuple(torch.as_tensor(p, device="cuda")
                             for p in planes), *gd, 8, damping, subx, suby)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
