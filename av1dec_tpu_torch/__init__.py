"""av1dec_tpu_torch — the av1dec_tpu AV1 decoder on PyTorch and CUDA.

A port of `av1dec_tpu` (JAX on a TPU) to one NVIDIA H100.  The host
half is copied from the JAX package as it is: the C++ front end
(`native/`, OBU/header parsing and the msac entropy decoder emitting
plan tensors), the container readers, the NumPy spec model
(`ops/spec/`), the wavefront schedule builder (`pipeline/wavefront.py`)
and the block walk of the host pixel path (`pipeline/recon.py`,
`pipeline/inter_pred.py`).  The device half is PyTorch (`ops/kernels/`,
`pipeline/device_recon.py`), with CDEF and the wavefront scan as
hand-written CUDA kernels: `csrc/cdef_frame.cu`, one launch per frame on
both paths, `csrc/cdef_filter.cu`, one launch per column shard of the
sharded CDEF (both from `csrc/cdef_common.cuh`), and
`csrc/wavefront_scan.cu`, one persistent launch per batch's scan.

The JAX package stays the reference: every part of this package gives
the same integers as its `av1dec_tpu` counterpart on the same inputs
(tests/test_torch_*.py).  This package imports neither `jax` nor
`av1dec_tpu`.
"""

__version__ = "0.1.0"

from av1dec_tpu_torch.config import DecoderConfig  # noqa: F401


def resolve_device(device="cuda"):
    """The torch.device the pixel path runs on.

    "cuda" (the default) needs a card and raises without one; the CPU
    runs only when the caller names it (`device="cpu"`).  There is no
    automatic fallback."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "av1dec_tpu_torch: no CUDA device; pass device='cpu' to "
                "run the pixel path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"av1dec_tpu_torch: unsupported device {device!r}")
    return dev
