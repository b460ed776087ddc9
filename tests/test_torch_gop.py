"""GOP-parallel decode of the port (`container.decode_gops_parallel`),
on the CPU, on the committed `gops` stream (key frames at TUs 0, 4, 8;
the stream of tests/test_gop_parallel.py):

- the keyframe index equals the JAX package's;
- two worker processes give the port's serial decode, the JAX
  package's GOP-parallel decode and the manifest;
- elastic recovery: the worker of GOP 4 dies once, the output is the
  same, and the marker shows the kill happened;
- a decode error inside a worker (a truncated TU) reaches the caller,
  each GOP submitted once: it is not retried as a dead worker.
"""
import struct

import pytest

from torch_port_helpers import manifest, stream_path, tus


def test_keyframe_index_matches_jax():
    from av1dec_tpu import container as jcontainer
    from av1dec_tpu_torch import container
    path = stream_path("gops")
    assert container.index_keyframes(path) == [0, 4, 8] == \
        jcontainer.index_keyframes(path)


def test_gop_parallel_matches_serial_jax_and_manifest(native_lib):
    from av1dec_tpu import container as jcontainer
    from av1dec_tpu_torch import container
    from av1dec_tpu_torch.api import decode_file
    path = stream_path("gops")
    stats = []
    got = container.decode_gops_parallel(path, workers=2, device="cpu",
                                         stats=stats)
    serial = decode_file(path, device="cpu")
    jax = jcontainer.decode_gops_parallel(path, workers=2)
    assert len(got) == len(serial) == len(jax) == 12
    assert [f.md5() for f in got] == [f.md5() for f in serial] == \
        [f.md5() for f in jax]
    assert [f.display_md5() for f in got] == manifest()["gops"]["frames"]
    assert [s["gop"] for s in stats] == [0, 4, 8]
    assert [len(s["frames"]) for s in stats] == [4, 4, 4]


def test_gop_parallel_max_frames_is_a_stream_limit(native_lib):
    from av1dec_tpu_torch import container
    from av1dec_tpu_torch.config import DecoderConfig
    got = container.decode_gops_parallel(
        stream_path("gops"), workers=1, config=DecoderConfig(max_frames=6),
        device="cpu")
    assert [f.display_md5() for f in got] == manifest()["gops"]["frames"][:6]


def test_elastic_recovery_after_a_worker_dies(monkeypatch, tmp_path,
                                              native_lib):
    from av1dec_tpu_torch import container
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("AV1DEC_TEST_KILL_GOP", "4")
    got = container.decode_gops_parallel(stream_path("gops"), workers=2,
                                         device="cpu")
    assert [f.display_md5() for f in got] == manifest()["gops"]["frames"]
    assert list(tmp_path.glob("av1dec_killed_gop_4_*"))


def test_decode_error_propagates_unretried(monkeypatch, tmp_path,
                                           native_lib):
    from av1dec_tpu_torch import container
    data = tus("gops")
    with open(stream_path("gops"), "rb") as f:
        head = f.read(32)
    bad = tmp_path / "gop8_truncated.ivf"
    with open(bad, "wb") as f:
        f.write(head)
        for i, tu in enumerate(data):
            if i == 8:  # the first TU of the last GOP, cut in half
                tu = tu[:len(tu) // 2]
            f.write(struct.pack("<IQ", len(tu), i) + tu)
    submitted = []

    class Counting(container.ProcessPoolExecutor):
        def submit(self, fn, job, *args, **kwargs):
            submitted.append(job[1])
            return super().submit(fn, job, *args, **kwargs)

    monkeypatch.setattr(container, "ProcessPoolExecutor", Counting)
    with pytest.raises(ValueError, match="parse error"):
        container.decode_gops_parallel(str(bad), workers=2, device="cpu")
    assert sorted(submitted) == [0, 4, 8]
