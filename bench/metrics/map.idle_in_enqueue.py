"""The share of the window, in %, in which no device record ran while the
host was inside a ``runner/enqueue`` span: the device's idle time that
waits on the host queueing a step (records on the program's clock,
``program.device_spans``).  At most ``map.idle_share``."""
import numpy as np

from bench.lib import program
from bench.lib.trace import union_ns


def read(rec):
    enq = program.of(rec, "runner/enqueue")
    dev = program.device_spans(rec)
    if enq is None or dev is None:
        return None
    lo, hi = rec.wall
    busy = np.clip(dev, lo, hi)
    idle_ns = union_ns(np.concatenate([np.clip(enq.wall, lo, hi), busy])) - union_ns(busy)
    return idle_ns / (rec.window_s * 1e9) * 100.0
