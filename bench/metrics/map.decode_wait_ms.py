"""Mean ``runner/to_host`` under the window's ``runner/decode`` spans, in
ms: the step's wait for the device and the copy of its [slots, V] f32
logits to the host."""
from bench.lib import program


def read(rec):
    s = program.of(rec, "runner/to_host", parent="runner/decode")
    return None if s is None else s.mean_ms()
