"""Mean ``runner/enqueue`` under the window's ``runner/decode`` spans, in
ms: the host's time to queue a decode step (its inputs' copies, every
launch of the model, the logits' cast), up to the copy that waits."""
from bench.lib import program


def read(rec):
    s = program.of(rec, "runner/enqueue", parent="runner/decode")
    return None if s is None else s.mean_ms()
