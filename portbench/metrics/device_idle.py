"""device_idle (%): the share of the traced window (between its marker
kernels) in which no kernel or copy ran on the card, from a whole
torch.profiler trace; None where the kernels were timed from CUDA
events instead (copies unseen)."""


def read(run):
    t = run.trace
    if t is None or not t.copies or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
