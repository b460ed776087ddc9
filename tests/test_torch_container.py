"""The port's container probe on the CPU: a raw low-overhead OBU stream
whose last OBU leaves out its size field (as the spec allows) is read
as an OBU stream, not taken for Annex B, and decodes equal to the
manifest; an Annex B file is still read as Annex B."""
import pytest

from torch_port_helpers import manifest, tus


def _obus(data):
    """(start, header bytes, payload start, end) of each OBU of a
    low-overhead OBU stream whose OBUs all carry their size."""
    from av1dec_tpu_torch.container import leb128_read
    out, pos = [], 0
    while pos < len(data):
        ext = (data[pos] >> 2) & 1
        size, body = leb128_read(data, pos + 1 + ext)
        out.append((pos, 1 + ext, body, body + size))
        pos = body + size
    return out


def _sizeless_tail(data):
    """`data` with its last OBU's has_size bit cleared and its size
    field dropped: the OBU then runs to the end of the stream."""
    start, hb, body, end = _obus(data)[-1]
    assert end == len(data)
    head = bytearray(data[start:start + hb])
    head[0] &= ~0x02
    return data[:start] + bytes(head) + data[body:]


@pytest.mark.parametrize("name", ["lowdelay", "multi"])
def test_sizeless_last_obu_reads_as_obu_stream(name, tmp_path, native_lib):
    from av1dec_tpu_torch.api import decode_file
    from av1dec_tpu_torch.container import (_walks_as_obu_stream,
                                            detect_format)
    raw = b"".join(tus(name))
    cut = _sizeless_tail(raw)
    assert len(cut) < len(raw) and not (cut[_obus(raw)[-1][0]] & 0x02)
    assert _walks_as_obu_stream(raw) and _walks_as_obu_stream(cut)
    path = tmp_path / f"{name}.obu"
    path.write_bytes(cut)
    assert detect_format(str(path)) == "obu"
    got = [f.display_md5() for f in decode_file(str(path), device="cpu")]
    assert got == manifest()[name]["frames"]


def test_sizeless_first_obu_and_annexb_are_not_obu_streams(tmp_path):
    from av1dec_tpu_torch.container import (_walks_as_obu_stream,
                                            detect_format, write_annexb)
    # a lone sizeless OBU is what an Annex B length byte can look like
    assert not _walks_as_obu_stream(bytes([0x10]) + bytes(15))
    path = tmp_path / "multi.av1"
    write_annexb(str(path), tus("multi"))
    assert detect_format(str(path)) == "annexb"
