"""1 - (real tokens) / (rows x width) over the window's ``engine/score``
spans, in %: the share of scored positions that are the batch's padding."""
from bench.lib import program


def read(rec):
    s = program.of(rec, "engine/score")
    if s is None:
        return None
    return (1.0 - s.total("tokens") / sum(a["rows"] * a["width"] for a in s.attrs)) * 100.0
