"""idle_share: the share of the traced window in which no operation ran on
the device (%): 1 - the union of the device operations' intervals / the
window."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
