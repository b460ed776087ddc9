"""fetch_ms (ms/frame): the seconds of stage `fetch` that
`api.decode_stream_batched(timings=...)` reports, summed over the
window's calls, a frame handed back.  None on an entry that reports no
stages."""


def read(run):
    s = run.record.stages
    if "fetch" not in s or not run.frames:
        return None
    return 1e3 * s["fetch"] / run.frames
