"""host_filter_ms (ms/frame): the mean of the program's `host.filter`
span (`FrameRecon._postfilter`: the NumPy deblock, the CDEF round trip
to the card, superres and loop restoration) over the window's frames on
the host pixel path, from `Decoder.stats`.  None where there are none,
or the records have no `spans_ms`."""


def read(run):
    st = [s["spans_ms"] for s in run.record.stats
          if "spans_ms" in s and s["recon_path"] == "host"]
    if not st:
        return None
    return sum(s.get("host.filter", 0.0) for s in st) / len(st)
