"""The benchmark's own host spans and launch counts, around the port's
calls, patched in the namespace each call is made from (as the port's
`chip_smoke.Launches` does), and undone on leaving.

- spans: `api.prep_batch` (on the batched entry's worker thread),
  `api.to_torch_inputs`, `api.scan_batch`, `api.postfilter_batch`,
  `NativeParser.parse_tu`, `DeviceRecon.fetch`, `DeviceRecon.run`,
  `FrameRecon.run` and `Decoder.decode`: (name, thread, start, end) on
  `time.perf_counter`;
- launches: every kernel launch through `cuda_build.launch`, by the
  kernel's name there (`cdef_frame`, `wavefront_scan`, `mc`, ...).  The
  kernel modules bind `launch` by name, so each module's binding is
  replaced.  `on_launch(name, entry, device, real, args)`, when given,
  makes the launch itself (the CUDA-event fallback of `trace`)."""
import sys
import threading
import time

SPANS = (("api", "prep_batch"), ("api", "to_torch_inputs"),
         ("api", "scan_batch"), ("api", "postfilter_batch"),
         ("NativeParser", "parse_tu"), ("DeviceRecon", "fetch"),
         ("DeviceRecon", "run"), ("FrameRecon", "run"),
         ("Decoder", "decode"))


def _owners():
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    from av1dec_tpu_torch.pipeline.recon import FrameRecon
    return {"api": api, "NativeParser": NativeParser,
            "DeviceRecon": DeviceRecon, "FrameRecon": FrameRecon,
            "Decoder": api.Decoder}


class Patches:
    """setattr with undo."""

    def __init__(self):
        self._undo = []

    def set(self, owner, name, value):
        self._undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo = []


class Instrument:
    """Inside `with`: host spans and launch counts (see the module)."""

    def __init__(self, spans=True, on_launch=None):
        self.want_spans = spans
        self.on_launch = on_launch
        self.spans = []        # (name, thread ident, t0, t1)
        self.launches = {}     # kernel name -> launches
        self._patches = Patches()
        self._lock = threading.Lock()

    def _span(self, label, fn):
        spans = self.spans

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((label, threading.get_ident(), t0,
                              time.perf_counter()))
        return wrapped

    def __enter__(self):
        from av1dec_tpu_torch.ops.kernels import cuda_build
        if self.want_spans:
            owners = _owners()
            for owner_name, attr in SPANS:
                owner = owners[owner_name]
                self._patches.set(owner, attr, self._span(
                    f"{owner_name}.{attr}", owner.__dict__[attr]))
        real = cuda_build.launch
        counts, lock, on_launch = self.launches, self._lock, self.on_launch

        def launch(name, entry, device, *args):
            with lock:
                counts[name] = counts.get(name, 0) + 1
            if on_launch is None:
                return real(name, entry, device, *args)
            return on_launch(name, entry, device, real, args)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__dict__", {}).get("launch") is real:
                self._patches.set(mod, "launch", launch)
        return self

    def __exit__(self, *_):
        self._patches.undo()
        return False
