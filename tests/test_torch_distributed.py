"""The port's scale-out layer over `torch.distributed`, on the CPU: one
launch of 2 gloo processes of `av1dec_tpu_torch.parallel.worker` (and
one of 4), whose results the tests read:

- the all_reduce of the rank ids, asserted on every rank;
- both halo exchanges equal the JAX package's (`shard_map` over a 1xN
  mesh of the virtual CPU devices of tests/conftest.py);
- the GOP shards are disjoint and their union is the serial decode;
- `cdef_sharded` on the `tiles` frame (its deblocked planes and real
  strengths) equals the port's whole-frame `_cdef_core` and the JAX
  `cdef_sharded` over a 1x2 mesh, at n_space 2 (and 4 and 2 under 4
  ranks);
- `decode_frames_sharded` of `multi`'s two frames over data=2 equals
  `DeviceRecon.run("cpu")` and the manifest;
- in one process, `cdef_local` equals the whole-frame CDEF through one
  `cdef_shard` call a shard, and
  `Decoder(DecoderConfig(space_shards=n))` decodes committed streams
  equal to the manifest on the shard path, with its two fallbacks.
"""
import numpy as np
import pytest

from torch_port_helpers import manifest, stream_path, tus


def _tiles_cdef_input():
    """The tiles frame's CDEF input as the chain gives it: (planes,
    gates as compute_gates orders them, bd)."""
    from av1dec_tpu_torch.api import decode_stream_batched
    from av1dec_tpu_torch.ops.kernels import cdef
    seen = []
    real = cdef.cdef_frame

    def keep(*args):
        seen.append(args)
        return real(*args)
    cdef.cdef_frame = keep
    try:
        decode_stream_batched(tus("tiles"), device="cpu", batch=1)
    finally:
        cdef.cdef_frame = real
    planes, y_pri, y_sec, uv_pri, uv_sec, bd, damping, sx, sy = seen[0]
    return planes, (y_pri, y_sec, uv_pri, uv_sec, damping, sx, sy), bd


@pytest.fixture(scope="module")
def cdef_input(tmp_path_factory, native_lib):
    from av1dec_tpu_torch.parallel.worker import save_cdef_input
    planes, gates, bd = _tiles_cdef_input()
    path = tmp_path_factory.mktemp("cdef") / "tiles.npz"
    save_cdef_input(str(path), planes, gates, bd)
    return str(path), planes, gates, bd


@pytest.fixture(scope="module")
def two(tmp_path_factory, cdef_input):
    from av1dec_tpu_torch.parallel.worker import launch
    return launch(2, str(tmp_path_factory.mktemp("two")),
                  ["--gops", stream_path("gops"), "--cdef", cdef_input[0],
                   "--n-space", 2, "--frames", stream_path("multi")],
                  backend="gloo", device="cpu", timeout=240)


@pytest.fixture(scope="module")
def four(tmp_path_factory, cdef_input):
    from av1dec_tpu_torch.parallel.worker import launch
    return launch(4, str(tmp_path_factory.mktemp("four")),
                  ["--cdef", cdef_input[0], "--n-space", 4, 2],
                  backend="gloo", device="cpu", timeout=240)


def _jax_halo(world):
    """Both JAX halo exchanges of the worker's blocks over a 1 x world
    mesh: ([cols of each rank], [fill of each rank])."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from av1dec_tpu.parallel import halo as jhalo
    from av1dec_tpu_torch.parallel.worker import halo_block
    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(1, world),
                ("data", "space"))
    whole = jnp.asarray(np.concatenate([halo_block(r)
                                        for r in range(world)], 1))
    out = []
    for fn in (lambda b: jhalo.exchange_halo_cols(b, 2),
               lambda b: jhalo.exchange_halo_cols_fill(b, 2, -1)):
        got = np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=P(None, "space"),
            out_specs=P(None, "space")))(whole))
        out.append(np.split(got, world, axis=1))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_all_reduce_and_halo_exchange(world, two, four):
    res = two if world == 2 else four
    cols, fill = _jax_halo(world)
    for r, rec in enumerate(res):
        assert (rec["rank"], rec["world"], rec["backend"]) == \
            (r, world, "gloo")
        assert rec["all_reduce"] == world * (world - 1) // 2
        assert rec["in_half_mesh"] == (r < max(1, world // 2))
        np.testing.assert_array_equal(rec["halo"]["cols"], cols[r])
        np.testing.assert_array_equal(rec["halo"]["fill"], fill[r])


def test_gop_shards_disjoint_and_cover_the_serial_decode(two):
    from av1dec_tpu_torch.api import decode_file
    gops = {}
    for rank, rec in enumerate(two):
        for gi, md5s in rec["gops"].items():
            assert gi not in gops, "overlapping GOP assignment"
            assert int(gi) % 2 == rank
            gops[int(gi)] = md5s
    assert sorted(gops) == [0, 1, 2]
    merged = [m for gi in sorted(gops) for m in gops[gi]]
    serial = decode_file(stream_path("gops"), device="cpu")
    assert merged == [f.display_md5() for f in serial] == \
        manifest()["gops"]["frames"]


def test_sharded_cdef_matches_core_and_jax(two, four, cdef_input):
    import jax

    from av1dec_tpu.parallel.sharded_cdef import cdef_sharded as jsharded
    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.parallel.worker import plane_md5s
    from jax.sharding import Mesh
    _, planes, gates, bd = cdef_input
    whole = plane_md5s(cdef._cdef_core(planes, *gates[:4], bd, *gates[4:]))
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                ("data", "space"))
    jax_out = jsharded([p.numpy() for p in planes],
                       tuple(g.numpy() if hasattr(g, "numpy") else g
                             for g in gates), bd, mesh)
    assert plane_md5s([np.asarray(p) for p in jax_out]) == whole
    for res, sizes in ((two, ["2"]), (four, ["4", "2"])):
        for rec in res:
            assert sorted(rec["cdef"]) == sorted(sizes)
            for n in sizes:
                assert rec["cdef"][n]["md5"] == whole, (len(res), n)
                assert rec["cdef"][n]["launches"] == 0  # CPU: plain
                assert rec["cdef"][n]["max_abs_err"] == 0


def test_sharded_cdef_refuses_unaligned_widths(cdef_input):
    """Every plane width must split into 8-column units per shard."""
    from av1dec_tpu_torch.parallel.mesh import Mesh
    from av1dec_tpu_torch.parallel.sharded_cdef import cdef_sharded
    _, planes, gates, bd = cdef_input
    mesh = Mesh(data=1, space=3, data_index=0, space_index=0,
                space_ranks=(0, 1, 2), data_group=None, space_group=None)
    with pytest.raises(ValueError, match="divisible"):
        cdef_sharded(planes, gates, bd, mesh)


def test_sharded_frames_match_device_recon_and_manifest(two):
    from av1dec_tpu_torch.api import display_md5
    from torch_port_helpers import parse
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    want = []
    for seq, hdr, plans in parse("multi", "torch")[:2]:
        dr = DeviceRecon(seq, hdr, plans)
        want.append(display_md5(dr.run("cpu"), dr.sch.bd,
                                hdr["upscaled_width"], hdr["frame_height"],
                                (dr.sch.sub_x, dr.sch.sub_y)))
    assert want == manifest()["multi"]["frames"]
    for rec in two:
        assert rec["frames"] == want


@pytest.mark.parametrize("n", [2, 4])
def test_decoder_refuses_space_shards(n, caplog, monkeypatch, native_lib):
    """`DecoderConfig.space_shards` in one process (once refused): with
    the CPU repeated n times as the process's devices, the Decoder runs
    CDEF in n column shards (`cdef_local`, counted) and decodes
    committed streams equal to the manifest; too few devices (the CPU
    once, as `local_devices` gives it) and a width that does not split
    (`w136`) fall back to one device, each with its warning on the
    `av1dec_tpu_torch` logger.  (The name is kept from the refusal
    test this replaced, so that test records before and after it
    compare.)"""
    import logging

    import torch

    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    from av1dec_tpu_torch.parallel import sharded_cdef

    def decode(name):
        dec = Decoder(DecoderConfig(space_shards=n), device="cpu")
        got = []
        for tu in tus(name):
            got += [f.display_md5() for f in dec.decode(tu)]
        dec.close()
        assert got == manifest()[name]["frames"], name

    assert sharded_cdef.local_devices("cpu") == [torch.device("cpu")]
    before = sharded_cdef.local_frames
    with caplog.at_level(logging.WARNING, logger="av1dec_tpu_torch"):
        decode("cdef_mid")
        monkeypatch.setattr(sharded_cdef, "local_devices",
                            lambda dev: [torch.device(dev)] * n)
        decode("w136")
    assert sharded_cdef.local_frames == before
    for name, frames in (("cdef_mid", 1), ("tiles", 1), ("c4", 8)):
        before = sharded_cdef.local_frames
        decode(name)
        assert sharded_cdef.local_frames - before == frames, name
    text = caplog.text
    assert f"1 device(s) for {n} shards" in text
    assert f"width 136 not divisible by 8*{n}" in text


@pytest.mark.parametrize("n", [1, 2, 4])
def test_cdef_local_matches_whole_frame(n, cdef_input):
    """`cdef_local` on the tiles frame, the CPU repeated n times, equals
    the whole-frame `_cdef_core`."""
    import torch

    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.parallel.sharded_cdef import cdef_local
    _, planes, gates, bd = cdef_input
    want = cdef._cdef_core(tuple(torch.as_tensor(p) for p in planes),
                           *(torch.as_tensor(g) for g in gates[:4]), bd,
                           *gates[4:])
    got = cdef_local(planes, gates, bd, [torch.device("cpu")] * n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [2, 4])
def test_cdef_local_runs_one_cdef_shard_per_shard(n, cdef_input,
                                                  monkeypatch):
    """`cdef_local` filters each shard with one `cdef_shard` call (one
    kernel launch on a card) on the shard's bordered planes, as
    `_local_pad` builds them, and its columns of the strengths."""
    import torch

    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.parallel.sharded_cdef import (_local_pad,
                                                        cdef_local)
    _, planes, gates, bd = cdef_input
    calls = []
    real = cdef.cdef_shard

    def spy(pads, *args):
        calls.append((pads, args))
        return real(pads, *args)
    monkeypatch.setattr(cdef, "cdef_shard", spy)
    cdef_local(planes, gates, bd, [torch.device("cpu")] * n)
    assert len(calls) == n
    uw = gates[0].shape[1] // n
    for s, (pads, args) in enumerate(calls):
        assert len(pads) == len(planes)
        for p, plane in zip(pads, planes):
            assert torch.equal(p, _local_pad(torch.as_tensor(plane), s, n))
        for got, g in zip(args[:4], gates[:4]):
            assert torch.equal(got, torch.as_tensor(g)[:, s * uw:
                                                       (s + 1) * uw])
        assert args[4:] == (bd,) + tuple(gates[4:])
