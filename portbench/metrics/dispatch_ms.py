"""dispatch_ms (ms/frame): the mean of the program's `dispatch` span
with its children (the MC and scan launches, `dispatch.scan`; the
postfilter's gates, maps and arguments built and uploaded,
`dispatch.post_args`; the postfilter chain queued) over the window's
inter frames on the device path, from `Decoder.stats`.  None where
there are none, or the records have no `spans_ms`."""


def read(run):
    st = [s["spans_ms"] for s in run.record.stats
          if "spans_ms" in s and not s["intra"] and
          s["recon_path"] == "device"]
    if not st:
        return None
    return sum(v for s in st for k, v in s.items()
               if k.split(".")[0] == "dispatch") / len(st)
