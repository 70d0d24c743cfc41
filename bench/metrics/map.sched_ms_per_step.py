"""Mean self time of the window's decode ``scheduler/step`` spans (outside
their runner child), in ms: the sampler over the step's [slots, V] f32
logits and the slots' bookkeeping."""
import numpy as np

from bench.lib import program


def read(rec):
    s = program.of(rec, "scheduler/step")
    if s is None:
        return None
    dec = [n for n, a in zip(s.self_ns, s.attrs) if a["phase"] == "decode"]
    return float(np.mean(dec)) / 1e6 if dec else None
