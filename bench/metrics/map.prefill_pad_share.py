"""1 - (prompt tokens) / (bucket positions) over the window's
``runner/prefill`` spans, in %: the share of prefilled positions that are
the bucket's padding."""
from bench.lib import program


def read(rec):
    s = program.of(rec, "runner/prefill")
    return None if s is None else (1.0 - s.total("tokens") / s.total("bucket")) * 100.0
