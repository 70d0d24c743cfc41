"""The program's own spans over the window, for the readers.

The program records spans inside its engine (``engine/score``,
``scheduler/step``, ``runner/{prefill,decode}`` and each runner step's
``runner/enqueue`` and ``runner/to_host``) on the
``repro_torch.obs.trace.Tracer`` installed on its thread.  A reader finds
that tracer as ``rec.program``; a record without one gives no spans, and
the reader ``None``.  ``cell.run`` installs none yet (PERF.md §7 names the
edit that would).  A span's ``wall0_ns`` and ``wall1_ns`` are on the
``time.time_ns`` clock, the clock the profiler's records are given in
(``lib/trace.py``), so device records can be placed inside program spans.
The profiler's clock wanders from it by up to a few ms at times, so
:func:`device_spans` first moves each step's records onto the program's
clock by the step's own copy to the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bench.lib.trace import union_ns


@dataclasses.dataclass
class Named:
    """The window's spans of one name, in order of start: ``wall`` [n, 2]
    epoch ns, ``attrs`` their attributes, ``self_ns`` [n] each one's
    duration less the union of its children's intervals."""
    wall: np.ndarray
    attrs: list[dict]
    self_ns: np.ndarray

    def __len__(self) -> int:
        return len(self.wall)

    def mean_ms(self) -> float:
        return float((self.wall[:, 1] - self.wall[:, 0]).mean()) / 1e6

    def total(self, key: str) -> int:
        return sum(a[key] for a in self.attrs)


def of(rec, name: str, parent: str | None = None) -> Named | None:
    """The spans ``name`` that start in the window (under a span ``parent``
    where given), or ``None`` where there are none."""
    tracer = getattr(rec, "program", None)
    if tracer is None:
        return None
    lo, hi = rec.wall
    spans = [s for s in tracer.spans() if s.wall1_ns is not None and lo <= s.wall0_ns < hi]
    by_id = {s.span_id: s for s in spans}
    sel = [s for s in spans if s.name == name and
           (parent is None or getattr(by_id.get(s.parent_id), "name", None) == parent)]
    if not sel:
        return None
    kids: dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append((s.wall0_ns, s.wall1_ns))
    wall = np.array([(s.wall0_ns, s.wall1_ns) for s in sel], np.int64)
    self_ns = np.array([(b - a) - union_ns(np.clip(np.array(kids.get(s.span_id, []), np.int64)
                                                   .reshape(-1, 2), a, b))
                        for s, (a, b) in zip(sel, wall.tolist())], np.int64)
    return Named(wall, [dict(s.attrs) for s in sel], self_ns)


def starts_inside(points: np.ndarray, spans: np.ndarray) -> int:
    """How many of ``points`` (epoch ns) fall in one of ``spans`` [n, 2],
    which do not overlap (spans of one name on one thread)."""
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    i = np.searchsorted(spans[:, 0], points, side="right") - 1
    inside = (i >= 0) & (points < spans[np.maximum(i, 0), 1])
    return int(inside.sum())



ALIGN_NS = 20_000_000    # farthest a step's copy to the host may lie from its ``to_host`` end


def device_spans(rec) -> np.ndarray | None:
    """The device records [n, 2] on the program's clock, or ``None`` where
    the run has none.  A runner step's records run after the host starts
    it (``runner/enqueue``) and end by the time its ``runner/to_host``
    returns with the step's ``Memcpy DtoH``: the copy whose end lies
    nearest that return (within ``ALIGN_NS``, one copy a step) anchors the
    step, and its records are those that end after the previous anchor and
    by this one.  The profiler's clock drifts from the program's by a few
    ms at times and then steps back, so where a step's records fall outside
    those bounds they move by the least that brings them inside: by one
    amount where one will do, else (the clock stepped within the step) by
    one at the first record and another at the copy, in proportion between.
    A return later than the copy's end is the host's and moves nothing."""
    if rec.trace is None or not len(rec.trace.spans):
        return None
    dev = rec.trace.spans
    enq, host = of(rec, "runner/enqueue"), of(rec, "runner/to_host")
    copies = np.sort(dev[[n.startswith("Memcpy DtoH") for n in rec.trace.names], 1])
    if enq is None or host is None or not len(copies):
        return dev
    h = np.sort(host.wall[:, 1])
    j = np.searchsorted(copies, h)
    before, after = copies[np.maximum(j - 1, 0)], copies[np.minimum(j, len(copies) - 1)]
    near = np.where(h - before <= after - h, before, after)
    single = np.ones(len(near), bool)
    single[1:] &= near[1:] != near[:-1]
    single[:-1] &= near[1:] != near[:-1]
    keep = single & (np.abs(h - near) <= ALIGN_NS)
    if not keep.any():
        return dev
    anchor, h = near[keep], h[keep]
    starts = np.sort(enq.wall[:, 0])
    s = starts[np.maximum(np.searchsorted(starts, h, side="right") - 1, 0)]
    k = np.minimum(np.searchsorted(anchor, dev[:, 1], side="left"), len(anchor) - 1)
    first = np.full(len(anchor), np.iinfo(np.int64).max)
    np.minimum.at(first, k, dev[:, 0])
    lo, hi = anchor - h, first - s          # the error: at least lo at the copy, at most hi at the start
    one = lo <= hi
    e0 = np.where(one, np.clip(0, lo, hi), np.minimum(hi, 0))
    e1 = np.where(one, e0, np.maximum(lo, 0))
    frac = np.clip((dev[:, 0] - first[k]) / np.maximum(anchor[k] - first[k], 1), 0.0, 1.0)
    return dev - (e0[k] + np.round(frac * (e1 - e0)[k]).astype(np.int64))[:, None]
