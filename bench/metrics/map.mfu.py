"""The FLOPs the served requests need (each prompt through every layer at
its real length with the head at its last token; each later token through
every layer against its context, with the head) over the window's time at
the card's bf16 peak, in %."""
from bench import peaks


def read(rec):
    reqs = [r for r in rec.adapter.requests() if r["times"]]
    if not reqs:
        return None
    flops = sum(rec.costs.prompt_flops(rec.arch, r["prompt"]) for r in reqs)
    flops += sum(rec.costs.decode_token_flops(rec.arch, c) for r in reqs for c in r["contexts"])
    return flops / (rec.window_s * peaks.for_device(rec.device_name).bf16) * 100.0
