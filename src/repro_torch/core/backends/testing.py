"""Instrumented backend wrappers for tests and benchmarks.

``CountingBackend`` wraps any ``GenerativeModel`` and records every batch
that actually reaches it (arrival order, prompt counts), with an optional
content-keyed slow-down for exercising scheduling/cancellation paths.
Thread-safe: the serving gateway calls it from dispatcher threads.
"""
from __future__ import annotations

import threading
import time


class CountingBackend:
    def __init__(self, model, *, slow_marker: str | None = None,
                 slow_s: float = 0.0):
        self._m = model
        self.slow_marker = slow_marker
        self.slow_s = slow_s
        self.lock = threading.Lock()
        self.batches: list[list[str]] = []      # arrival order
        self.first_prompt = threading.Event()

    def _note(self, prompts) -> None:
        with self.lock:
            self.batches.append(list(prompts))
        self.first_prompt.set()
        if self.slow_marker and any(self.slow_marker in p for p in prompts):
            time.sleep(self.slow_s)

    @property
    def n_prompts(self) -> int:
        with self.lock:
            return sum(len(b) for b in self.batches)

    def saw(self, marker: str) -> bool:
        with self.lock:
            return any(marker in p for b in self.batches for p in b)

    # -- GenerativeModel protocol -----------------------------------------
    def predicate(self, prompts):
        self._note(prompts)
        return self._m.predicate(prompts)

    def generate(self, prompts):
        self._note(prompts)
        return self._m.generate(prompts)

    def compare(self, prompts):
        self._note(prompts)
        return self._m.compare(prompts)

    def choose(self, prompts, n_options):
        self._note(prompts)
        return self._m.choose(prompts, n_options)
