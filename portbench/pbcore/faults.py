"""Faults planted under the timed path, for the checks that show the
comparison fails them (`portbench/control.py` on the card at a cell's
size, `portbench/tests/test_portbench_faults.py` on the CPU at a test's
size).  Each is a context manager that patches the port's public entry
points in place and undoes it on leaving.

- `answer_altered`: one pixel of every frame changed where the frame
  is made (`DeviceRecon.fetch`, `FrameRecon.run`).
- `half_left_out`: the batched entry hands back the first half of a
  call's frames; the `Decoder` hands back nothing from every second
  temporal unit.
- `state_unchanged`: each frame handed back is the one before it again,
  as if the step had left its output state as it was.

The control is not a fault: `Runner(control=True)` clears the lowest
bit of every pixel before the comparison, a pixel path one bit short of
the configuration's 8 bits."""
import contextlib

from pbcore.spans import Patches

FAULTS = ("answer_altered", "half_left_out", "state_unchanged")


def _flip(planes):
    planes = list(planes)
    p = planes[0].copy()
    p[0, 0] ^= 1
    planes[0] = p
    return planes


@contextlib.contextmanager
def planted(name):
    from av1dec_tpu_torch import api
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    from av1dec_tpu_torch.pipeline.recon import FrameRecon
    patches = Patches()
    if name == "answer_altered":
        fetch, host_run = DeviceRecon.fetch, FrameRecon.run
        patches.set(DeviceRecon, "fetch",
                    lambda self, final: _flip(fetch(self, final)))
        patches.set(FrameRecon, "run", lambda self: _flip(host_run(self)))
    elif name == "half_left_out":
        batched, decode = api.decode_stream_batched, api.Decoder.decode
        patches.set(api, "decode_stream_batched",
                    lambda datas, *a, **k:
                    (lambda out: out[:len(out) // 2])(
                        batched(datas, *a, **k)))
        seen = {"n": 0}

        def half(self, tu):
            out = decode(self, tu)
            seen["n"] += 1
            return out if seen["n"] % 2 else []
        patches.set(api.Decoder, "decode", half)
    elif name == "state_unchanged":
        batched, decode = api.decode_stream_batched, api.Decoder.decode
        patches.set(api, "decode_stream_batched",
                    lambda datas, *a, **k:
                    (lambda out: out[:1] + out[:-1])(
                        batched(datas, *a, **k)))
        last = {}

        def stale(self, tu):
            out = decode(self, tu)
            prev = last.get(id(self))
            if out:
                last[id(self)] = out[-1]
            return [prev if prev is not None else f for f in out]
        patches.set(api.Decoder, "decode", stale)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        patches.undo()
