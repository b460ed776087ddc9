"""h2d_mib (MiB/frame): the mean of the program's `h2d_bytes` (bytes
copied from the host to the card through `tracing.to_device`) over
every frame record of the window's `Decoder.stats`.  None where the
records have no copy counters, or count no copy (a run without a
card)."""


def read(run):
    st = [s["h2d_bytes"] for s in run.record.stats if "h2d_bytes" in s]
    if not st or not sum(st):
        return None
    return sum(st) / len(st) / 2 ** 20
