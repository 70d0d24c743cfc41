"""Device records (kernels, copies, memsets) that start inside a
``runner/decode`` span, over the number of those spans: the work a decode
step queues, counted where the device ran it (records on the program's
clock, ``program.device_spans``)."""
from bench.lib import program


def read(rec):
    dec = program.of(rec, "runner/decode")
    dev = program.device_spans(rec)
    if dec is None or dev is None:
        return None
    return program.starts_inside(dev[:, 0], dec.wall) / len(dec)
