"""Host spans and the device trace of a run.

:class:`Spans` records the harness's own spans around calls into the
program, in ``time.perf_counter`` seconds and, for matching against the
device trace, ``time.time_ns`` (the profiler's records are in the same
epoch nanoseconds).  :class:`DeviceTrace` runs ``torch.profiler`` with
CUDA activity only over the window and reads the raw records (kernels,
copies, memsets of every stream): reading the profiler's event tree for a
served window of a million launches takes minutes, its raw records
seconds.  Busy time is the union of the records' intervals.
"""
from __future__ import annotations

import time

import numpy as np


class Spans:
    def __init__(self):
        self.items: list[dict] = []

    def add(self, name: str, t0: float, t1: float, wall0_ns: int, **attrs) -> dict:
        span = {"name": name, "t0": t0, "t1": t1, "wall0_ns": wall0_ns,
                "wall1_ns": wall0_ns + int((t1 - t0) * 1e9), **attrs}
        self.items.append(span)
        return span

    def of(self, name: str) -> list[dict]:
        return [s for s in self.items if s["name"] == name]

    def wrap(self, name: str, fn, attrs=None, result=None):
        """``fn`` timed under a span ``name``; ``attrs(args, kwargs)`` adds
        attributes, ``result(span, value)`` reads the return value."""
        def wrapped(*args, **kwargs):
            w0 = time.time_ns()
            t0 = time.perf_counter()
            value = fn(*args, **kwargs)
            t1 = time.perf_counter()
            span = self.add(name, t0, t1, w0, **(attrs(args, kwargs) if attrs else {}))
            if result is not None:
                result(span, value)
            return value
        return wrapped


def union_ns(spans: np.ndarray) -> int:
    """Length of the union of the [start, end) intervals in ``spans`` [n, 2]:
    each interval, in order of start, adds what reaches past every earlier
    end.  A copy of the method of the program's ``chip_smoke.union_ns``."""
    if not len(spans):
        return 0
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    start, end = spans[:, 0], spans[:, 1]
    reach = np.concatenate([[start[0]], np.maximum.accumulate(end)[:-1]])
    return int(np.maximum(end - np.maximum(start, reach), 0).sum())


def gaps_ns(spans: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The idle intervals [n, 2] of [lo, hi) outside every span."""
    if not len(spans):
        return np.array([[lo, hi]], np.int64)
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    reach = np.maximum.accumulate(spans[:, 1])
    starts = np.concatenate([[lo], reach])
    ends = np.concatenate([spans[:, 0], [hi]])
    starts = np.maximum(starts, lo)
    ends = np.minimum(ends, hi)
    keep = ends > starts
    return np.stack([starts[keep], ends[keep]], axis=1)


class DeviceTrace:
    """The profiler over one window; after :meth:`stop`, ``names`` and
    ``spans`` ([n, 2] epoch ns) of every device record."""

    def __init__(self):
        import torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.names: list[str] = []
        self.spans = np.zeros((0, 2), np.int64)
        self.read_s = 0.0

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self) -> None:
        import torch
        self._prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        names, spans = [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                names.append(e.name())
                spans.append((e.start_ns(), e.end_ns()))
        self.names = names
        self.spans = np.array(spans, np.int64).reshape(-1, 2)
        self.read_s = time.perf_counter() - t0

    def busy_ns(self, lo: int | None = None, hi: int | None = None) -> int:
        s = self.spans
        if lo is not None:
            s = np.clip(s, lo, hi)
        return union_ns(s)

    def time_of(self, match) -> tuple[float, int]:
        """(seconds, records) of the device records whose name ``match``
        accepts, summed."""
        sel = [i for i, n in enumerate(self.names) if match(n)]
        if not sel:
            return 0.0, 0
        s = self.spans[sel]
        return float((s[:, 1] - s[:, 0]).sum()) / 1e9, len(sel)

    def top_ops(self, n: int = 10) -> list[list]:
        totals: dict[str, int] = {}
        for name, (a, b) in zip(self.names, self.spans.tolist()):
            totals[name] = totals.get(name, 0) + (b - a)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


def idle_gaps(trace: DeviceTrace, spans: Spans, lo: int, hi: int, n: int = 10) -> list[list]:
    """The ``n`` longest idle gaps of the device in [lo, hi), each named by
    the innermost host span (the latest to start) covering its middle."""
    gaps = gaps_ns(trace.spans, lo, hi)
    if not len(gaps):
        return []
    order = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:n]
    out = []
    for a, b in gaps[order].tolist():
        mid = (a + b) // 2
        cover = [s for s in spans.items if s["wall0_ns"] <= mid < s["wall1_ns"]]
        name = max(cover, key=lambda s: s["wall0_ns"])["name"] if cover else "harness"
        out.append([f"{name} @{(a - lo) / 1e9:.3f}s", (b - a) / 1e9])
    return out
