"""fps (frames/s): every frame handed back in the window over the
window's length on the host clock, from the window's opening to the
return of its last call."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
