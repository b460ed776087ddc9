"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled with
`nvcc` for `sm_90a` into `av1dec_tpu_torch/build/lib<name>.so` at first
use, or when it or a header of `csrc/` is newer than its library (one
nvcc process per source, all started together), and loaded with
ctypes.  Nothing here runs at import: this module is imported on
machines without `nvcc` or a card.  A kernel that does not build
raises.  `launch` calls a kernel's C entry on a card's current stream.
"""
import contextlib
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (C functions, their argtypes); every pointer and the stream are
# void*
KERNELS = {
    "cdef_filter": (("cdef_shard",), [_P] * 10 + [_I] * 7 + [_P]),
    "cdef_frame": (("cdef_frame",),
                   [_P] * 3 + [_I] * 3 + [_P] * 7 + [_I] * 7 + [_P]),
    "wavefront_scan": (("wavefront_scan", "wavefront_scan_floor"),
                       [_P, _I, _P]),
    "mc": (("mc_frame",), [_P, _I, _P]),
    "itx": (("itx_residuals",), [_P, _I, _P]),
    "deblock": (("deblock_frame",), [_P, _I, _P]),
    "superres": (("superres_frame",), [_P, _I, _P]),
    "wiener": (("wiener_frame",), [_P, _I, _P]),
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
    """The library is missing, or older than its source or a header of
    `csrc/` (the kernels share `cdef_common.cuh`)."""
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src] + glob.glob(os.path.join(_CSRC, "*.cuh"))
    return os.path.getmtime(so) < max(map(os.path.getmtime, deps))


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
        fn_names, argtypes = KERNELS[name]
        for fn_name in fn_names:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def param_names(ints, per_item, items):
    """A kernel's parameter names in its `enum Param` order: `ints`, then
    each name of `per_item` once for each of `items` items, suffixed with
    the item's index."""
    return list(ints) + [f"{k}{i}" for k in per_item for i in range(items)]


def param_list(names, params):
    """The values of `params` (name -> tensor or int) in `names` order;
    0 for a name it does not have (an item a call does not use)."""
    return [params.get(k, 0) for k in names]


@contextlib.contextmanager
def no_device_sync(device):
    """On a card, make any device->host synchronisation inside the block
    raise (torch's sync debug mode "error"): a launch only enqueues
    work, never waits for it."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def launch(name, entry, device, *args):
    """Calls the C function `entry` of kernel `name` with `args`, then the
    current stream of `device` (a card), under that device and
    `no_device_sync`.  A list among `args` is passed as the address of
    an int64 array of its items (a tensor's data pointer, or an int),
    which lives until the call returns.  Raises RuntimeError when the
    function returns an error."""
    fn = getattr(load_kernel(name), entry)
    arrays = [np.asarray([v.data_ptr() if torch.is_tensor(v) else int(v)
                          for v in a], np.int64) if isinstance(a, list)
              else a for a in args]
    with torch.cuda.device(device), no_device_sync(device):
        err = fn(*[a.ctypes.data if isinstance(a, np.ndarray) else a
                   for a in arrays],
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
