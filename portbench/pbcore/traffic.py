"""The one traffic generator: a mix file's parameters and a seed in, an
endless list of calls out.

A mix (`portbench/traffic/<name>.json`) names its `streams` (committed
under `portbench/streams/`) and its `call`:

- `"frames"`: a call hands `frames_per_call` temporal units of one
  stream to the entry at once (all-intra streams: each TU decodes
  alone).  The units are successive seeded permutations of the stream's
  units, so every call holds each unit equally often, in another order.
- `"stream"`: a call is one whole stream, its units in order, through a
  fresh decoder.

The streams of successive calls go round in rounds, each a seeded
permutation of `streams` (a call a stream), and a window closes only at
the end of a round: every seed draws the same work in another order,
and every window holds whole rounds.  `random.Random` takes any whole
number as its seed."""
import random
from dataclasses import dataclass


@dataclass(frozen=True)
class Call:
    stream: str
    units: tuple  # indices of the stream's temporal units, in call order
    last: bool = True  # the last call of its round


def calls(traffic, n_units, seed):
    """Endless generator of the mix's calls.  `n_units`: stream name ->
    its number of temporal units."""
    rng = random.Random(seed)
    kind = traffic["call"]
    while True:
        order = list(traffic["streams"])
        rng.shuffle(order)
        for k, s in enumerate(order):
            n = n_units[s]
            last = k == len(order) - 1
            if kind == "stream":
                yield Call(s, tuple(range(n)), last)
                continue
            if kind != "frames":
                raise ValueError(f"unknown call kind {kind!r}")
            want = int(traffic["frames_per_call"])
            units = []
            while len(units) < want:
                perm = list(range(n))
                rng.shuffle(perm)
                units += perm
            yield Call(s, tuple(units[:want]), last)


# temporal units of each stream a "stream" mix warms up with: its key
# frame and the first inter frames, every path and kernel its frames take
WARM_UNITS = 3


def warm_calls(traffic, n_units, batch=None):
    """One call of each stream, units in stream order: every shape the
    mix's calls use ("stream" mixes: the first WARM_UNITS units;
    "frames" mixes: two batches of `batch` frames, so that the second's
    host prep overlaps the first's device work, as in every call)."""
    out = []
    for s in traffic["streams"]:
        n = n_units[s]
        if traffic["call"] == "stream":
            out.append(Call(s, tuple(range(min(n, WARM_UNITS)))))
        else:
            want = int(traffic["frames_per_call"])
            if batch:
                want = min(want, 2 * int(batch))
            out.append(Call(s, tuple(i % n for i in range(want))))
    return out
