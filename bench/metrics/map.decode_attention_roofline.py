"""The least time the card needs for the decode attention of the rows the
steps advanced (each row's K and V up to its length read once, q read and
the output written once; slots with no request not credited), over the
device time of the ``decode_attention`` kernels, in %.  Each launch (one
layer of one step) is bound by the larger of its FLOPs at the bf16 peak
and its bytes at the HBM peak."""
from bench import peaks


def read(rec):
    if rec.trace is None:
        return None
    secs, n = rec.trace.time_of(lambda name: "decode_attention" in name)
    if not n or secs <= 0:
        return None
    pk = peaks.for_device(rec.device_name)
    bound = 0.0
    for contexts in rec.adapter.decode_rows():
        flops = nbytes = 0
        for c in contexts:
            f, b = rec.costs.decode_attention_bound(rec.arch, c)
            flops, nbytes = flops + f, nbytes + b
        bound += max(flops / pk.bf16, nbytes / pk.hbm)
    return bound * rec.arch.layers / secs * 100.0
