"""Host time inside ``sem_filter_gold`` outside ``ModelRunner.logprobs``
(whose calls end in the copy of the log-prob plane to the host): prompt
building, tokenizing, padding, picking each row's last position, the
scores; the window's total over its scored batches, in ms."""


def read(rec):
    ops = rec.spans.of("sem_filter_gold")
    steps = rec.spans.of("logprobs")
    if not ops or not steps:
        return None
    outside = sum(s["t1"] - s["t0"] for s in ops) - sum(s["t1"] - s["t0"] for s in steps)
    return outside / len(steps) * 1e3
