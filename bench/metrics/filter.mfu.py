"""The FLOPs the scored rows need (every layer's products over each row's
real tokens, causal attention over its real length, the LM head at its
last token only) over the window's time at the card's bf16 peak, in %."""
from bench import peaks


def read(rec):
    batches = rec.adapter.batches()
    if not batches:
        return None
    flops = sum(rec.costs.prompt_flops(rec.arch, t) for batch in batches for t in batch)
    return flops / (rec.window_s * peaks.for_device(rec.device_name).bf16) * 100.0
