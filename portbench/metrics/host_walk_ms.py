"""host_walk_ms (ms/frame): the mean of the program's `host.walk` self
time (the block walk of `FrameRecon.run`) and its `host.inter_pred`
(`InterPredictor.predict_block`, accumulated) over the window's frames
on the host pixel path, from `Decoder.stats`.  None where there are
none, or the records have no `spans_ms`."""


def read(run):
    st = [s["spans_ms"] for s in run.record.stats
          if "spans_ms" in s and s["recon_path"] == "host"]
    if not st:
        return None
    return sum(s.get("host.walk", 0.0) + s.get("host.inter_pred", 0.0)
               for s in st) / len(st)
