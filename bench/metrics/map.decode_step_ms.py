"""The window's total time in ``ModelRunner.decode`` calls over their
number, in ms: the mean decode step as the host sees it (the call ends
with the logits on the host)."""


def read(rec):
    dec = rec.spans.of("decode")
    if not dec:
        return None
    return sum(s["t1"] - s["t0"] for s in dec) / len(dec) * 1e3
