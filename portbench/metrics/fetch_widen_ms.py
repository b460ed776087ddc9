"""fetch_widen_ms (ms/frame): the mean of the program's `fetch.widen`
span (the fetched planes widened to int64 on the host, in
`DeviceRecon.fetch`) over the window's inter frames on the device path,
from `Decoder.stats`.  None where there are none, or their records have
no such span (a program without it)."""


def read(run):
    st = [s["spans_ms"] for s in run.record.stats
          if "spans_ms" in s and not s["intra"] and
          s["recon_path"] == "device"]
    if not st or not any("fetch.widen" in s for s in st):
        return None
    return sum(s.get("fetch.widen", 0.0) for s in st) / len(st)
