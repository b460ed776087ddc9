"""tu_parse_ms (ms/frame): the program's `parse` span (the native
front end's `parse_tu` of each temporal unit, charged to the first
frame record the unit makes) summed over the window's
`Decoder.stats` records, over those records.  None where the records
have no `spans_ms` (a program without the port's tracing, or an entry
that keeps no stats)."""


def read(run):
    st = [s for s in run.record.stats if "spans_ms" in s]
    if not st:
        return None
    return sum(s["spans_ms"].get("parse", 0.0) for s in st) / len(st)
