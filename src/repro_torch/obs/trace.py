"""Span-based tracing for the semantic-operator stack.

One ``Tracer`` per traced run (or per gateway); spans nest through a
thread-local context so every layer — session, plan stage, operator,
partition fragment, dispatcher batch, kernel dispatch, index build, cache
lookup — attributes its work to the right parent without passing handles
through call signatures.  Tracing is off by default: the module-level
``span()`` returns a shared no-op context manager when no tracer is
installed on the calling thread, so the off path costs one thread-local
read per call site.

Cross-thread propagation mirrors ``core.accounting``: the coordinating
thread snapshots its context with ``capture()`` and fragment / worker /
dispatcher threads re-install it with ``activate_ctx()``, so spans opened
on other threads still parent into the owning session or operator span.

Durations are on ``time.monotonic``.  Each tracer also reads
``time.monotonic_ns`` and ``time.time_ns`` once, together, when it is made
or reset, so every span gives its start and end on the epoch clock as well
(``Span.wall0_ns`` / ``wall1_ns``): the clock of ``torch.profiler``'s
device records, against which host spans are matched.

Exports: ``Tracer.export_jsonl()`` (one span per line) and
``Tracer.export_chrome()`` (Chrome ``trace_event`` JSON, loadable in
Perfetto / ``chrome://tracing``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time

_ctx = threading.local()


def current_tracer() -> "Tracer | None":
    return getattr(_ctx, "tracer", None)


def current_span() -> "Span | None":
    return getattr(_ctx, "span", None)


class Span:
    """One timed unit of work.  ``attrs`` are typed-by-convention: counts
    are ints, seconds/thresholds are floats, identifiers are strings."""

    __slots__ = ("span_id", "parent_id", "name", "kind", "t0", "t1",
                 "attrs", "thread", "wall_off_ns")

    def __init__(self, span_id: int, parent_id: int | None, name: str,
                 kind: str, attrs: dict, wall_off_ns: int = 0):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t0 = time.monotonic()
        self.t1: float | None = None
        self.attrs = attrs
        self.thread = threading.get_ident()
        self.wall_off_ns = wall_off_ns   # epoch ns - monotonic ns, the tracer's anchor

    @property
    def wall0_ns(self) -> int:
        """Start in epoch nanoseconds (``time.time_ns``)."""
        return self.wall_off_ns + round(self.t0 * 1e9)

    @property
    def wall1_ns(self) -> int | None:
        """End in epoch nanoseconds; ``None`` while the span is open."""
        return None if self.t1 is None else self.wall_off_ns + round(self.t1 * 1e9)

    @property
    def dur_s(self) -> float:
        return ((self.t1 if self.t1 is not None else time.monotonic())
                - self.t0)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def add(self, key: str, n: float = 1) -> None:
        self.attrs[key] = self.attrs.get(key, 0) + n

    def as_dict(self, origin: float = 0.0) -> dict:
        return {
            "span_id": self.span_id, "parent_id": self.parent_id,
            "name": self.name, "kind": self.kind,
            "ts_us": round((self.t0 - origin) * 1e6, 1),
            "dur_us": round(self.dur_s * 1e6, 1),
            "thread": self.thread, "attrs": _jsonable(self.attrs),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, kind={self.kind!r}, "
                f"dur={self.dur_s * 1e3:.2f}ms, attrs={self.attrs})")


class _NoopSpan:
    """Shared sink for all span mutation on the tracing-off path."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def add(self, key: str, n: float = 1) -> None:
        pass


class _NoopCM:
    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return NOOP_SPAN

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()
_NOOP_CM = _NoopCM()

# attribute keys whose values are summed when aggregating spans
_COUNTER_KEYS = ("oracle_calls", "proxy_calls", "embed_calls",
                 "compare_calls", "generate_calls", "cache_hits",
                 "scanned_bytes", "candidate_pairs",
                 "pairs_pruned_by_inference", "block_prompts",
                 "block_fallbacks")


class Tracer:
    """Collects finished spans; thread-safe; bounded (oldest runs should
    export and ``reset()`` — a serving gateway traces forever otherwise)."""

    def __init__(self, *, max_spans: int = 1_000_000):
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._ids = itertools.count(1)
        self._max_spans = max_spans
        self.dropped = 0
        self.origin = time.monotonic()
        self.wall_off_ns = _wall_offset_ns()

    # -- span lifecycle ---------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, kind: str = "span", **attrs):
        """Open a span parented to this thread's current span (if this
        tracer is the one installed here), install it as current, and
        record it on exit."""
        parent = current_span() if current_tracer() is self else None
        sp = Span(next(self._ids),
                  parent.span_id if parent is not None else None,
                  name, kind, attrs, self.wall_off_ns)
        prev = (current_tracer(), current_span())
        _ctx.tracer, _ctx.span = self, sp
        try:
            yield sp
        finally:
            sp.t1 = time.monotonic()
            _ctx.tracer, _ctx.span = prev
            with self._lock:
                if len(self._spans) < self._max_spans:
                    self._spans.append(sp)
                else:
                    self.dropped += 1

    # -- queries ----------------------------------------------------------
    def spans(self, kind: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self._spans)
        if kind is not None:
            out = [s for s in out if s.kind == kind]
        out.sort(key=lambda s: s.t0)
        return out

    def children_index(self) -> dict:
        """span_id -> list of child spans (each list sorted by start)."""
        idx: dict = {}
        for s in self.spans():
            if s.parent_id is not None:
                idx.setdefault(s.parent_id, []).append(s)
        return idx

    def subtree(self, root: Span) -> list[Span]:
        idx = self.children_index()
        out, todo = [], [root]
        while todo:
            s = todo.pop()
            out.append(s)
            todo.extend(idx.get(s.span_id, ()))
        return out

    def session_spans(self, sid: str | None = None) -> list[Span]:
        return [s for s in self.spans(kind="session")
                if sid is None or s.attrs.get("sid") == sid]

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
            self.wall_off_ns = _wall_offset_ns()

    # -- aggregation ------------------------------------------------------
    def stage_summary(self) -> dict:
        """Per-(kind, name) wall/count/call roll-up — the gateway snapshot's
        span-derived stage breakdown.  Wall is *inclusive* per span; only
        compare totals within one kind."""
        out: dict = {}
        for s in self.spans():
            row = out.setdefault(f"{s.kind}/{s.name}",
                                 {"count": 0, "wall_s": 0.0})
            row["count"] += 1
            row["wall_s"] = round(row["wall_s"] + s.dur_s, 6)
            for k in _COUNTER_KEYS:
                v = s.attrs.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    row[k] = row.get(k, 0) + v
        return out

    # -- export -----------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.as_dict(self.origin)) + "\n")
        return len(spans)

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` document (complete 'X' events, µs)."""
        events = []
        for s in self.spans():
            events.append({
                "name": s.name, "cat": s.kind, "ph": "X",
                "ts": round((s.t0 - self.origin) * 1e6, 1),
                "dur": round(s.dur_s * 1e6, 1),
                "pid": 1, "tid": s.thread,
                "args": _jsonable({**s.attrs, "span_id": s.span_id,
                                   "parent_id": s.parent_id}),
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> int:
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


def _wall_offset_ns() -> int:
    """One anchor pair: epoch ns less monotonic ns, the epoch reading taken
    between two monotonic ones and set against their midpoint."""
    m0 = time.monotonic_ns()
    wall = time.time_ns()
    return wall - (m0 + time.monotonic_ns()) // 2


# -- module-level context helpers ----------------------------------------

def span(name: str, kind: str = "span", **attrs):
    """Open a span on this thread's installed tracer; no-op (and no attrs
    evaluation cost beyond the call) when tracing is off."""
    t = current_tracer()
    if t is None:
        return _NOOP_CM
    return t.span(name, kind, **attrs)


def span_in(tracer: "Tracer | None", name: str, kind: str = "span", **attrs):
    """Open a span on an explicit tracer (dispatcher/subscription threads
    that hold a tracer handle rather than inheriting thread context)."""
    if tracer is None:
        return _NOOP_CM
    return tracer.span(name, kind, **attrs)


def capture() -> tuple:
    """Snapshot (tracer, span) for re-installation on another thread."""
    return (current_tracer(), current_span())


@contextlib.contextmanager
def activate_ctx(ctx: tuple):
    """Install a captured (tracer, span) pair on this thread; fragment
    workers use this so their spans parent into the coordinator's span."""
    prev = (current_tracer(), current_span())
    _ctx.tracer, _ctx.span = ctx
    try:
        yield
    finally:
        _ctx.tracer, _ctx.span = prev


@contextlib.contextmanager
def activate(tracer: "Tracer | None"):
    """Install a tracer (with no current span) on this thread — the entry
    point for a traced run on a worker thread."""
    prev = (current_tracer(), current_span())
    _ctx.tracer, _ctx.span = tracer, None
    try:
        yield tracer
    finally:
        _ctx.tracer, _ctx.span = prev


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, int, float, bool)) else repr(x)
                      for x in v]
        else:
            out[k] = repr(v)
    return out
