"""The share of the window inside ``ModelRunner.prefill_into_slot`` calls, in %."""


def read(rec):
    pre = rec.spans.of("prefill")
    if not pre:
        return None
    return sum(s["t1"] - s["t0"] for s in pre) / rec.window_s * 100.0
