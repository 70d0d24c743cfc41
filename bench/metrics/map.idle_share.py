"""1 - (union of every device record's interval) / (the traced window),
in %: the share of the window in which nothing ran on the card."""


def read(rec):
    if rec.trace is None or not len(rec.trace.spans):
        return None
    busy = rec.trace.busy_ns(*rec.wall) / 1e9
    return (1.0 - busy / rec.window_s) * 100.0
