"""key_frame_ms (ms/frame): the mean `ms` of the window's intra frames
in `Decoder.stats` (the whole `decode` of the frame, host clock).  None
on an entry that keeps no stats."""


def read(run):
    ms = [s["ms"] for s in run.record.stats if s["intra"]]
    return sum(ms) / len(ms) if ms else None
