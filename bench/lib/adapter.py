"""Adapters: the program's entries as the cells call them.

A mix's ``entry`` names its adapter, ``bench/adapters/<entry>.py``, which
holds a class ``Adapter`` (on :class:`Base`) and a function
``plant_fault()``.  An adapter builds the program's objects from the
benchmark's weights, wraps the model-step calls of that one engine
instance in host spans, keeps what the program answers, and after the
window judges a sample of those answers against the family's plain
reference: ``check(table, seed)`` gives the numbers that the cell's
limits hold, and ``control()`` the same numbers with the reference at
float8 in the program's place, on the same sample.  The wrappers time
calls and keep return values; they change no argument and no result.
``plant_fault()`` alters an answer or a token where the program produces
it and returns the function that takes the fault out again (for
``calibrate.py --fault`` and the tests; ``run.py`` never plants one).
"""
from __future__ import annotations

import gc
import importlib
import re
import time
from types import ModuleType

import torch

from bench.lib.family import Family
from bench.lib.trace import Spans


def load(entry: str) -> ModuleType:
    if not re.fullmatch(r"[A-Za-z0-9_]+", entry):
        raise ValueError(f"entry {entry!r}: letters, digits and _ only")
    return importlib.import_module(f"bench.adapters.{entry}")


def sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Base:
    def __init__(self, fam: Family, weights: dict, mix, spans: Spans):
        self.fam, self.arch, self.mix, self.spans = fam, fam.arch, mix, spans
        self.weights = weights
        self.cfg = fam.program.config(fam.arch)
        self.params = fam.program.params(weights, fam.arch)
        self.calls: list[dict] = []

    def fields(self, row: dict) -> dict:
        return {k: row[k] for k in self.mix["fields"]}

    def op_span(self, name, fn, rows):
        w0 = time.time_ns()
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        self.spans.add(name, t0, t1, w0, rows=len(rows))
        return out

    def warm(self, rows: list[dict]) -> None:
        """One call through the timed entry, then forget it."""
        self.call(rows)
        sync()
        self.calls.clear()
        self.spans.items.clear()

    def capture(self, rows: list[dict]) -> None:
        """Keep the step outputs of these rows for the check, where the
        entry has any."""

    def release(self) -> None:
        """Drop the program's objects (the weights stay: they are the
        benchmark's, and the reference reads them)."""
        for k in ("engine", "model", "params"):
            self.__dict__.pop(k, None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
