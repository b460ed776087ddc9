"""kernel_roofline (%): the sum of the traced launches' bounds (each the
larger of its bytes at 3.35 TB/s and its operations at the int32 and
int8 rates, `pbcore/work.py`) over the sum of their device times.  None
where the bounds could not be matched launch for launch."""


def read(run):
    t = run.trace
    if t is None or run.bound_s is None:
        return None
    device = sum(t.kernel_s.values())
    if device <= 0:
        return None
    return 100.0 * sum(run.bound_s.values()) / device
