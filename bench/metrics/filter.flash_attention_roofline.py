"""The least time the card needs for the attention the scored rows need
(each row at its real length, causal, q/k/v read once and the output
written once; padding not credited), over the device time of the
``flash_attention`` kernels, in %.  The bound of each launch (one layer
of one batch) is the larger of its FLOPs at the bf16 peak and its bytes at
the HBM peak."""
from bench import peaks


def read(rec):
    if rec.trace is None:
        return None
    secs, n = rec.trace.time_of(lambda name: "flash_attention" in name and "bwd" not in name)
    if not n or secs <= 0:
        return None
    pk = peaks.for_device(rec.device_name)
    bound = 0.0
    for batch in rec.adapter.batches():
        flops = nbytes = 0
        for t in batch:
            f, b = rec.costs.flash_attention_bound(rec.arch, t)
            flops, nbytes = flops + f, nbytes + b
        bound += max(flops / pk.bf16, nbytes / pk.hbm)
    return bound * rec.arch.layers / secs * 100.0
