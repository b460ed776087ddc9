"""d2h_mib (MiB/frame): the mean of the program's `d2h_bytes` (bytes
copied from the card to the host through `tracing.to_host`) over every
frame record of the window's `Decoder.stats`.  None where the records
have no copy counters, or count no copy (a run without a card)."""


def read(run):
    st = [s["d2h_bytes"] for s in run.record.stats if "d2h_bytes" in s]
    if not st or not sum(st):
        return None
    return sum(st) / len(st) / 2 ** 20
