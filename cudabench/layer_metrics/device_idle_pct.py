"""Device: the share of the traced window in which no operation ran on the card, one
less the union of the device intervals over the window's length."""


def read(tr):
    t = tr.trace
    if t is None or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / (t.window[1] - t.window[0]))
