"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled with
`nvcc` for `sm_90a` into `av1dec_tpu_torch/build/lib<name>.so` at first
use (one nvcc process per source, all started together) and loaded with
ctypes.  Nothing here runs at import: this module is imported on
machines without `nvcc` or a card.  A kernel that does not build
raises.
"""
import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (C function, argtypes); every pointer and the stream are void*
KERNELS = {
    "cdef_filter": ("cdef_filter_plane",
                    [_P] * 9 + [_I, _I, _I, _P]),
    "cdef_frame": ("cdef_frame",
                   [_P] * 3 + [_I] * 3 + [_P] * 7 + [_I] * 7 + [_P]),
}

_loaded = {}


def _nvcc():
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit on the machine with the "
                           "card")
    return cand


def _paths(name):
    return (os.path.join(_CSRC, name + ".cu"),
            os.path.join(_BUILD, f"lib{name}.so"))


def _stale(name):
    src, so = _paths(name)
    return not os.path.exists(so) or \
        os.path.getmtime(so) < os.path.getmtime(src)


def build_kernels(names=None, verbose=False):
    """Compile the named kernels (default: all) that are missing or
    older than their source, all nvcc processes at once.  Returns the
    seconds spent (0.0 when nothing was stale).  `verbose` adds
    `-Xptxas -v` and prints the compiler's report.  Raises RuntimeError
    with the compiler output when a build fails."""
    names = list(KERNELS if names is None else names)
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if _stale(n)]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
            procs = []
            for n in todo:
                src, _ = _paths(n)
                tmp_so = os.path.join(tmp, f"lib{n}.so")
                log = open(tmp_so + ".log", "wb")
                cmd = [nvcc] + _NVCC_FLAGS + \
                    (["-Xptxas", "-v"] if verbose else []) + \
                    ["-o", tmp_so, src]
                procs.append((n, tmp_so, log,
                              subprocess.Popen(cmd, stdout=log,
                                               stderr=subprocess.STDOUT)))
            for n, tmp_so, log, p in procs:
                rc = p.wait()
                log.close()
                with open(tmp_so + ".log") as f:
                    text = f.read()
                if rc != 0:
                    raise RuntimeError(f"nvcc failed for {n}:\n{text}")
                if verbose and text:
                    print(f"[nvcc {n}]\n{text}", flush=True)
                os.replace(tmp_so, _paths(n)[1])
        return time.monotonic() - t0


def load_kernel(name):
    """The ctypes library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(_paths(name)[1])
        fn_name, argtypes = KERNELS[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
