"""Device time of the device-to-host copies (``Memcpy DtoH`` records of
the profiler) over the window's scored batches, in ms."""


def read(rec):
    steps = rec.spans.of("logprobs")
    if rec.trace is None or not steps:
        return None
    secs, n = rec.trace.time_of(lambda name: name.startswith("Memcpy DtoH"))
    if not n:
        return None
    return secs / len(steps) * 1e3
