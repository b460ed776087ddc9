"""Checkpoint and resume of the port's Decoder (`save_state`,
`load_state`), on the CPU:

- saved after TU `cut` and restored into a fresh Decoder, the decode
  finishes byte-identical to the straight decode and to the manifest,
  on five streams (`obmconly` alternates the device and host paths, so
  its DPB holds frames of both), and on `bframes` equal to the JAX
  Decoder's own save and resume;
- the blob is an `.npz` read without pickle: garbage, a pickle (whose
  payload must not run), another format version and a missing entry
  are refused with ValueError;
- a native state cut short, or with a vector length beyond its bytes,
  is refused with ValueError before anything is allocated, and the
  decoder that refused it decodes on from its own state.
"""
import io
import json
import pickle
import struct

import numpy as np
import pytest

from torch_port_helpers import manifest, tus

CASES = [("bframes", 4), ("lowdelay", 3), ("grain", 2), ("obmconly", 3),
         ("multi", 1)]


def _resume(name, cut, before_save=None, after_load=None):
    """Frames of the decode cut at TU `cut` and resumed in a fresh
    Decoder; `before_save` and `after_load` see the two Decoders."""
    from av1dec_tpu_torch.api import Decoder
    data = tus(name)
    assert 0 < cut < len(data)
    dec = Decoder(device="cpu")
    got = []
    for tu in data[:cut]:
        got += dec.decode(tu)
    if before_save is not None:
        before_save(dec)
    blob = dec.save_state()
    dec.close()
    dec2 = Decoder(device="cpu")
    dec2.load_state(blob)
    if after_load is not None:
        after_load(dec2)
    for tu in data[cut:]:
        got += dec2.decode(tu)
    dec2.close()
    return got


@pytest.mark.parametrize("name,cut", CASES)
def test_resume_matches_straight_decode_and_manifest(name, cut, native_lib):
    from av1dec_tpu_torch.api import Decoder
    dec = Decoder(device="cpu")
    straight = []
    for tu in tus(name):
        straight += dec.decode(tu)
    dec.close()
    got = _resume(name, cut)
    assert len(got) == len(straight) > 0
    assert [f.md5() for f in got] == [f.md5() for f in straight]
    assert [f.display_md5() for f in got] == manifest()[name]["frames"]


def test_resume_matches_jax_resume(native_lib):
    from av1dec_tpu.api import Decoder as JDecoder
    from av1dec_tpu.config import DecoderConfig as JConfig
    name, cut = "bframes", 4
    data = tus(name)
    cfg = JConfig(use_spec_kernels=True)
    jdec = JDecoder(cfg)
    want = []
    for tu in data[:cut]:
        want += jdec.decode(tu)
    blob = jdec.save_state()
    jdec.close()
    jdec = JDecoder(cfg)
    jdec.load_state(blob)
    for tu in data[cut:]:
        want += jdec.decode(tu)
    jdec.close()
    got = _resume(name, cut)
    assert [f.md5() for f in got] == [f.md5() for f in want]


def test_dpb_of_both_paths_restores_to_host_planes(native_lib):
    """obmconly at TU 3 holds a device-path frame (with device planes)
    and host-path frames; after the restore every slot holds host planes
    of the saved dtype, and slots that shared a frame share one."""
    seen = []

    def look(dec):
        slots = [s for s in dec._dpb.values() if s is not None]
        groups = sorted(
            sorted(i for i, t in dec._dpb.items() if t is s)
            for s in {id(s): s for s in slots}.values())
        seen.append(({s.dev_planes is not None for s in slots}, groups,
                     [[p.dtype for p in s.planes] for s in slots]))

    got = _resume("obmconly", 3, look, look)
    (kinds, groups, dtypes), (kinds2, groups2, dtypes2) = seen
    assert kinds == {True, False} and kinds2 == {False}
    assert (groups2, dtypes2) == (groups, dtypes)
    assert [f.display_md5() for f in got] == \
        manifest()["obmconly"]["frames"]


def _blob():
    from av1dec_tpu_torch.api import Decoder
    dec = Decoder(device="cpu")
    for tu in tus("multi")[:1]:
        dec.decode(tu)
    blob = dec.save_state()
    dec.close()
    return blob


def _rewrite(blob, edit):
    """The blob with its entries passed through `edit(dict)`."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    edit(arrays)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load(blob):
    from av1dec_tpu_torch.api import Decoder
    dec = Decoder(device="cpu")
    try:
        dec.load_state(blob)
    finally:
        dec.close()


def test_load_state_rejects_garbage(native_lib):
    with pytest.raises(ValueError):
        _load(b"\x00" * 64)


def test_load_state_refuses_a_pickle(tmp_path, native_lib):
    target = tmp_path / "made_by_unpickling"

    class Payload:
        def __reduce__(self):
            return (open, (str(target), "w"))

    with pytest.raises(ValueError):
        _load(pickle.dumps(Payload()))
    assert not target.exists()


def test_load_state_rejects_other_version_and_missing_entry(native_lib):
    blob = _blob()
    _load(blob)

    def bump(arrays):
        head = json.loads(arrays["header"].tobytes())
        head["version"] += 1
        arrays["header"] = np.frombuffer(json.dumps(head).encode(),
                                         np.uint8)

    for edit in (bump, lambda a: a.pop("native"), lambda a: a.pop("f0_p1")):
        with pytest.raises(ValueError):
            _load(_rewrite(blob, edit))


def _vector_length_at(native, n_mi, n_mv):
    """Offset of the first saved segment-id vector's int64 length in a
    native state: n_mi bytes follow it, then the motion-vector vector's
    length n_mv."""
    key = struct.pack("<q", n_mi)
    at = native.find(key)
    while at >= 0:
        nxt = at + 8 + n_mi
        if native[nxt:nxt + 8] == struct.pack("<q", n_mv):
            return at
        at = native.find(key, at + 1)
    raise AssertionError("no segment-id vector in the native state")


@pytest.mark.parametrize("how", ["truncated", "huge_vector"])
def test_load_state_rejects_bad_native_state(how, native_lib):
    from av1dec_tpu_torch.api import Decoder
    from torch_port_helpers import parse
    blob = _blob()
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        native = z["native"].tobytes()
    _, hdr, _ = parse("multi", "torch")[0]
    rows, cols = hdr["mi_rows"], hdr["mi_cols"]
    at = _vector_length_at(native, rows * cols,
                           ((rows + 1) // 2) * ((cols + 1) // 2) * 2)
    if how == "truncated":
        bad = native[:at + 8 + rows * cols // 2]
    else:
        bad = native[:at] + struct.pack("<q", 1 << 62) + native[at + 8:]
    blob_bad = _rewrite(blob, lambda a: a.__setitem__(
        "native", np.frombuffer(bad, np.uint8)))
    data = tus("multi")
    dec = Decoder(device="cpu")
    got = [f.display_md5() for f in dec.decode(data[0])]
    with pytest.raises(ValueError):
        dec.load_state(blob_bad)
    for tu in data[1:]:
        got += [f.display_md5() for f in dec.decode(tu)]
    dec.close()
    assert got == manifest()["multi"]["frames"]
