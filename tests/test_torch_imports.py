"""av1dec_tpu_torch imports neither jax nor av1dec_tpu, and its entry
points run on the card unless the caller names the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "av1dec_tpu_torch")


def _port_files():
    """The package, and the scripts that run it on the card."""
    out = [os.path.join(_REPO, "chip_smoke.py"),
           os.path.join(_REPO, "tools", "profile_torch_scan.py")]
    for root, _, files in os.walk(_PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, _REPO)[:-3].replace(os.sep, ".")
        if not rel.startswith("av1dec_tpu_torch") or \
                rel.endswith("__main__"):
            continue
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    return mods


_BLOCKER = r'''
import importlib, importlib.abc, sys
sys.modules["jax"] = None

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "av1dec_tpu" or name.startswith("av1dec_tpu."):
            raise ImportError("port imported " + name)
        return None

sys.meta_path.insert(0, Block())
for m in sys.argv[1:]:
    importlib.import_module(m)
bad = [m for m in sys.modules if m == "av1dec_tpu" or
       m.startswith("av1dec_tpu.") or m == "jax" or m.startswith("jax.")]
assert not [m for m in bad if sys.modules[m] is not None], bad
print("ok", len(sys.argv) - 1)
'''


def test_port_imports_without_jax_or_reference():
    mods = _port_modules() + ["chip_smoke"]
    assert "av1dec_tpu_torch.ops.kernels.wavefront" in mods
    r = subprocess.run([sys.executable, "-c", _BLOCKER] + mods,
                       cwd=_REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == f"ok {len(mods)}"


def _imports(path):
    """(line, top-level module) of every import statement of a file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            yield node.lineno, n.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_no_jax_or_reference_imports_in_source(path):
    for line, top in _imports(path):
        assert top not in ("jax", "jaxlib", "av1dec_tpu"), \
            f"{path}:{line} imports {top}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_no_pickle_imports_in_source(path):
    """Checkpoints are read without pickle (`Decoder.load_state`)."""
    for line, top in _imports(path):
        assert top not in ("pickle", "cPickle", "dill"), \
            f"{path}:{line} imports {top}"


def test_entry_points_need_a_card_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from av1dec_tpu_torch import resolve_device
    from av1dec_tpu_torch.api import Decoder, decode_stream_batched
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        Decoder()
    with pytest.raises(RuntimeError):
        decode_stream_batched([])
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu").type == "cpu"
    Decoder(device="cpu").close()


def test_scale_out_needs_a_card_or_a_named_backend(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from torch_port_helpers import stream_path
    from av1dec_tpu_torch.container import decode_gops_parallel
    from av1dec_tpu_torch.parallel import dist
    from av1dec_tpu_torch.parallel.sharded_frames import \
        decode_frames_sharded
    from av1dec_tpu_torch.parallel.worker import launch
    path = stream_path("gops")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_gops_parallel(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.decode_my_gops(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_frames_sharded([], None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch(2, str(tmp_path / "card"))
    # the CPU named and no backend: the workers' own rule refuses
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        launch(2, str(tmp_path / "cpu"), device="cpu", timeout=120)
    with pytest.raises(ValueError, match="backend='gloo'"):
        dist.initialize_distributed("localhost:1", 2, 0)
    for name in ("AV1DEC_COORDINATOR", "AV1DEC_NUM_PROCS",
                 "AV1DEC_PROC_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize_distributed(backend="gloo")


def test_cli_needs_a_card_unless_cpu_is_named(tmp_path):
    from torch_port_helpers import stream_path
    r = subprocess.run([sys.executable, "-m", "av1dec_tpu_torch",
                        stream_path("base"), "--md5", "--device", "cpu"],
                       cwd=_REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(r.stdout.strip()) == 32
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m", "av1dec_tpu_torch",
                            stream_path("base"), "--md5"], cwd=_REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "device='cpu'" in r.stderr
