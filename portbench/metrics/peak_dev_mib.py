"""peak_dev_mib (MiB): `torch.cuda.max_memory_allocated()` over the
window, the peak statistics reset at its opening."""


def read(run):
    return run.memory_peak_bytes / 2 ** 20 if run.memory_peak_bytes else None
