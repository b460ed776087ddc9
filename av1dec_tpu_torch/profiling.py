"""Device intervals of a function's calls on the card, from torch.profiler.

A trace can miss the launches made just after it starts, so
`device_events` starts it with lead calls and a marker kernel
(`torch.cuda._sleep`), and keeps only what begins after the marker.
"""

MARKER = "spin_kernel"  # the kernel that torch.cuda._sleep launches
LEAD = 10  # calls of fn() before the marker


def device_events(fn, iters):
    """The device events (kernels and copies) of the last `iters` of
    `LEAD + iters` calls of fn() in one torch.profiler trace: those that
    begin after the marker kernel launched between the two runs of calls.
    None if the trace lost the marker."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e for e in ev if MARKER in e.name]
    if not marks:
        return None
    return [e for e in ev if e.time_range.start >= marks[-1].time_range.end]
