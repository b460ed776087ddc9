"""The port's CLI on the CPU: `--gop-workers` gives the serial decode's
MD5 and per-frame records, and `--y4m` writes the bytes the JAX
package's CLI writes."""
import json
import os
import subprocess
import sys

from torch_port_helpers import stream_path

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(pkg, *args):
    r = subprocess.run([sys.executable, "-m", pkg, stream_path("gops"),
                        *args], cwd=_REPO, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def _cli(pkg, *args):
    return _run(pkg, *args).stdout.strip()


def test_gop_workers_md5_equals_serial(native_lib):
    serial = _cli("av1dec_tpu_torch", "--device", "cpu", "--md5")
    assert len(serial) == 32
    assert _cli("av1dec_tpu_torch", "--device", "cpu", "--gop-workers", "2",
                "--md5") == serial


def test_y4m_bytes_equal_the_jax_cli(tmp_path, native_lib):
    port, ref = tmp_path / "port.y4m", tmp_path / "jax.y4m"
    _cli("av1dec_tpu_torch", "--device", "cpu", "--y4m", str(port))
    _cli("av1dec_tpu", "--device", "off", "--y4m", str(ref))
    data = port.read_bytes()
    assert data.startswith(b"YUV4MPEG2 W128 H96 F30:1 Ip A1:1 C420jpeg\n")
    assert data.count(b"FRAME\n") == 12
    assert data == ref.read_bytes()


def test_gop_workers_stats_equal_serial(native_lib):
    """`--stats` prints one record per frame on both paths, the GOP
    workers' Decoders' records in stream order."""
    def records(*args):
        r = _run("av1dec_tpu_torch", "--device", "cpu", "--stats", *args)
        return [json.loads(line) for line in r.stderr.splitlines()
                if line.startswith("{")]
    serial, gops = records(), records("--gop-workers", "2")
    assert len(serial) == 12
    timing = ("ms", "inter_plan_ms")
    assert [{k: v for k, v in r.items() if k not in timing}
            for r in gops] == \
        [{k: v for k, v in r.items() if k not in timing} for r in serial]
