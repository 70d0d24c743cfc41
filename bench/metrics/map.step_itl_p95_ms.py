"""The 95th percentile of the gaps between a request's successive tokens,
in ms, read from the ends of the window's ``scheduler/step`` spans by their
``rids``: a prefill step gives its request the first token, each decode
step one more to every request it names.  The program's own reading of
what the harness times as ``map_itl_p95_ms``."""
from bench.lib import program
from bench.lib.stats import percentile


def read(rec):
    s = program.of(rec, "scheduler/step")
    if s is None:
        return None
    last: dict[int, int] = {}      # each request's latest token; a prefill starts one anew
    gaps = []
    for (_, end), a in zip(s.wall.tolist(), s.attrs):
        for rid in a["rids"]:
            if a["phase"] == "decode" and rid in last:
                gaps.append(end - last[rid])
            last[rid] = end
    return percentile(gaps, 95) / 1e6 if gaps else None
