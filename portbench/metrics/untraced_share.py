"""untraced_share (%): the program's `decode` self time (what of each
frame's decode no span inside it covers) summed over the window's
`Decoder.stats` records, over the sum of their `ms`.  None where the
records have no `spans_ms`."""


def read(run):
    st = [s for s in run.record.stats if "spans_ms" in s]
    ms = sum(s["ms"] for s in st)
    if not st or ms <= 0:
        return None
    return 100.0 * sum(s["spans_ms"].get("decode", 0.0) for s in st) / ms
