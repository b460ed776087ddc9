"""kernel_ms (ms/frame): device time of every kernel launched through
`cuda_build.launch` in the traced window, from a whole torch.profiler
trace (or, where no trace was whole, CUDA events around each launch), a
frame of that window."""


def read(run):
    t = run.trace
    if t is None or not run.trace_frames:
        return None
    return 1e3 * sum(t.kernel_s.values()) / run.trace_frames
