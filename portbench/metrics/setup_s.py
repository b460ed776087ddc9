"""setup_s (s): host clock from the process's start to the window's
opening: torch and CUDA start, the kernels built or loaded, the streams
read, and one warm call of each stream of the mix."""


def read(run):
    return run.setup_s
