"""host_frame_ms (ms/frame): the mean `ms` of the window's frames that
took the host pixel path (`recon_path` "host" in `Decoder.stats`)."""


def read(run):
    ms = [s["ms"] for s in run.record.stats if s["recon_path"] == "host"]
    return sum(ms) / len(ms) if ms else None
