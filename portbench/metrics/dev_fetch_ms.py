"""dev_fetch_ms (ms/frame): the mean of the program's `fetch` span with
its children (`fetch.copy`: the planes copied to the host, which waits
for the card, and widened to int64; `fetch.tail`: the host filter
tail) over the window's inter frames on the device path, from
`Decoder.stats`.  None where there are none, or the records have no
`spans_ms`."""


def read(run):
    st = [s["spans_ms"] for s in run.record.stats
          if "spans_ms" in s and not s["intra"] and
          s["recon_path"] == "device"]
    if not st:
        return None
    return sum(v for s in st for k, v in s.items()
               if k.split(".")[0] == "fetch") / len(st)
